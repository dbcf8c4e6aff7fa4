"""`clean_caption` of the port gives the JAX package's string for every
caption of a corpus that reaches each rule of the cleaning: URLs, HTML
tags and entities, @handles, CJK, dashes and quotes, IP addresses, file
names, long numbers and hashtags, `--ar` flags, shop phrases, dimensions
and stray punctuation. Both run in this process, so `ftfy` and
BeautifulSoup are present for both or absent for both."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import pytest

from pixart_sigma_tpu.utils.prompt import clean_caption as jax_clean_caption
from pixart_sigma_tpu_torch.utils.prompt import clean_caption

CORPUS = [
    "A photo of a cat sitting on a windowsill",
    "  Trailing   spaces and UPPER case words  ",
    "see https://example.com/some/path?q=1 and www.example.org/page for more",
    "visit shop.example.co.uk or images.example.ru/x today",
    "<p>an <b>HTML</b> caption &amp; entities &quot;quoted&quot;</p>",
    "<person> walks a dog, photo by @some_user123 on the beach",
    "東京の夜景 night view of tokyo 夜景 with neon",
    "a — long – dash ‒ and ― more ‐ dashes ─ here",
    "«guillemets» “curly” ‘single’ `backtick´ quotes ¨",
    "server at 192.168.0.1 and time 12:30   ",
    "download image_001.jpg or photo.png and file.pdf free download",
    "hashtags #12 #123456 and number 1234567 in text",
    "a cat on a sofa --ar 16:9",
    "portrait of a woman --hw 1152:896 high detail",
    "worldwide free shipping on all items, click for details",
    "page 12 of the catalogue, jpg images and png",
    "size 1920x1080 or 3.5×2 cm, model ab12345 and x1y2z3",
    "a\\nmultiline\\ncaption with escaped newlines",
    "dots.... and ellipsis... and . lonely . dots",
    "weird ### punctuation ®®® ©© ™ {braces} [brackets] |pipes| \\back/slash* *",
    "a-b_c-d_e-f_g underscores and dashes everywhere",
    "'quoted whole caption'",
    "\"double quoted caption\"",
    "_leading underscore, trailing plus+",
    ".hidden",
    "ratio : spaced colon : here",
    "one,two.three/four words",
    "a%20url%20encoded+caption",
    "",
    "   ",
    12345,
]


@pytest.mark.parametrize("apply_twice", [True, False])
def test_clean_caption_matches_jax(apply_twice):
    for caption in CORPUS:
        want = jax_clean_caption(caption, apply_twice=apply_twice)
        assert clean_caption(caption, apply_twice=apply_twice) == want, repr(caption)


def test_corpus_reaches_the_rules():
    """The corpus is not passed through unchanged: URLs, tags, CJK, IPs,
    file names, flags and shop phrases are cut."""
    out = [clean_caption(c) for c in CORPUS]
    joined = " | ".join(out)
    for gone in ("https", "www", "<b>", "東京", "192.168", ".jpg", "shipping", "@some"):
        assert gone not in joined, gone
    assert out[0] == "a photo of a cat sitting on a windowsill"
