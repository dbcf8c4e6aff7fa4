"""Prompt utilities (port of pixart_sigma_tpu/utils/prompt.py): the
DeepFloyd caption cleaning applied before T5 tokenization (`clean_caption`)
and the `--ar h:w` / `--hw h:w` prompt flags.

`ftfy` and BeautifulSoup are optional and imported where used, as in the
JAX package: without them the text goes through html.unescape and a
tag-stripping regex, so both packages give the same string in the same
environment.
"""

from __future__ import annotations

import html
import re
import urllib.parse as ul
from typing import Dict, Tuple

import numpy as np

_BAD_PUNCT = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + r"\)" + r"\(" + r"\]" + r"\[" + r"\}" + r"\{"
    + r"\|" + "\\" + r"\/" + r"\*" + r"]{1,}"
)


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def _strip_html(text: str) -> str:
    try:
        from bs4 import BeautifulSoup

        return BeautifulSoup(text, features="html.parser").text
    except ImportError:
        return re.sub(r"<[^>]*>", "", text)


def clean_caption(caption: str, apply_twice: bool = True) -> str:
    """The training-time caption cleaning, applied twice as upstream."""
    out = _clean_once(str(caption))
    if apply_twice:
        out = _clean_once(out)
    return out


def _clean_once(caption: str) -> str:
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    # urls
    caption = re.sub(
        r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "", caption)
    caption = re.sub(
        r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "", caption)
    caption = _strip_html(caption)
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    # CJK ranges
    for rng in (
        r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
        r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
        r"[\u4e00-\u9fff]+",
    ):
        caption = re.sub(rng, "", caption)
    # unify dashes and quotes
    caption = re.sub(
        r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B"
        r"\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+",
        "-", caption)
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    caption = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", caption)
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    caption = re.sub(r"\\n", " ", caption)
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    caption = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "", caption)
    caption = re.sub(r"[\"\']{2,}", r'"', caption)
    caption = re.sub(r"[\.]{2,}", r" ", caption)
    caption = re.sub(_BAD_PUNCT, r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    dash_underscore = re.compile(r"(?:\-|\_)")
    if len(re.findall(dash_underscore, caption)) > 3:
        caption = re.sub(dash_underscore, " ", caption)
    caption = _basic_clean(caption)
    caption = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)
    caption = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", caption)
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)
    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(
        r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "", caption
    )
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)
    caption = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ", caption)
    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)
    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption.strip()
    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)
    return caption.strip()


def prepare_prompt_ar(prompt: str, ratios: Dict[str, Tuple[float, float]]):
    """Parse `--ar h:w` / `--hw h:w` out of a prompt; snap to the closest bin.

    Returns (clean_prompt, hw [1, 2], ar [1, 1], custom_hw [1, 2]) float32.
    """
    prompt_clean = prompt.strip()
    ar_match = re.search(r"--ar\s+(\d+):(\d+)", prompt_clean)
    hw_match = re.search(r"--hw\s+(\d+):(\d+)", prompt_clean)
    custom_h = custom_w = None
    if hw_match:
        custom_h, custom_w = float(hw_match.group(1)), float(hw_match.group(2))
        ar_val = custom_h / custom_w
    elif ar_match:
        ar_val = float(ar_match.group(1)) / float(ar_match.group(2))
    else:
        ar_val = 1.0
    key = min(ratios.keys(), key=lambda r: abs(float(r) - ar_val))
    default_hw = ratios[key]
    prompt_clean = re.sub(r"--ar\s+\d+:\d+", "", prompt_clean)
    prompt_clean = re.sub(r"--hw\s+\d+:\d+", "", prompt_clean).strip()
    custom_hw = default_hw if custom_h is None else [custom_h, custom_w]
    return (
        prompt_clean,
        np.asarray([default_hw], dtype=np.float32),
        np.asarray([[float(key)]], dtype=np.float32),
        np.asarray([custom_hw], dtype=np.float32),
    )
