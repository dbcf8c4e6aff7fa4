"""Build data_info.json from a folder of images and their captions.

Port of tools/convert_images_to_json.py, the same records: one
{path, prompt, ratio, height, width} per image under `--image-dir`
(recursively, files sorted per folder; `path` relative to the folder,
`ratio` = height / width), the prompt from `--captions` (a JSON map keyed
by file name or relative path) or else from a sidecar `.txt` beside the
image, or empty.

    python -m pixart_sigma_tpu_torch.tools.convert_images_to_json \\
        --image-dir IMGS --out data/data_info.json [--captions captions.json]
"""

from __future__ import annotations

import argparse
import json
import os

from PIL import Image

IMG_EXT = {".png", ".jpg", ".jpeg", ".webp"}


def records(image_dir: str, captions: dict) -> list:
    out = []
    for dirpath, _, files in os.walk(image_dir):
        for fn in sorted(files):
            if os.path.splitext(fn)[1].lower() not in IMG_EXT:
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, image_dir)
            with Image.open(full) as im:
                w, h = im.size
            prompt = captions.get(fn, captions.get(rel, ""))
            sidecar = os.path.splitext(full)[0] + ".txt"
            if not prompt and os.path.exists(sidecar):
                with open(sidecar) as f:
                    prompt = f.read().strip()
            out.append({"path": rel, "prompt": prompt, "ratio": h / w, "height": h, "width": w})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="data_info.json from an image folder")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out", required=True, help="output data_info.json path")
    p.add_argument("--captions", default=None, help="captions.json {name: prompt}")
    args = p.parse_args(argv)
    captions = {}
    if args.captions:
        with open(args.captions) as f:
            captions = json.load(f)
    recs = records(args.image_dir, captions)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(recs, f)
    print(f"{len(recs)} records -> {args.out}")


if __name__ == "__main__":
    main()
