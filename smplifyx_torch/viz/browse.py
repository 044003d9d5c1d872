"""Results browser: re-render fitted meshes from result pickles to images.

Counterpart of `smplifyx_tpu/viz/browse.py` (the reference's
render_results.py and render_pkl.py viewers), headless: one overlay PNG
per result pickle instead of an interactive window.  The forwards run on
the card unless `--platform cpu`; the rasteriser runs on the host.

    python -m smplifyx_torch.viz.browse --results out/results \
        --images data/images --out out/overlays \
        [--model_folder models --gender neutral | --synthetic_model] \
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

from smplifyx_torch.data.keypoints import load_image
from smplifyx_torch.utils.device import device_for_platform, resolve_device
from smplifyx_torch.viz.render import render_result_pickle
from smplifyx_torch.viz.viewer import add_model_args, load_viewer_model


def main(argv=None):
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True,
                   help="results tree containing <frame>/000.pkl")
    p.add_argument("--images", default=None,
                   help="optional folder with the original images")
    p.add_argument("--out", required=True)
    add_model_args(p)
    args = p.parse_args(argv)

    model = load_viewer_model(
        args, resolve_device(device_for_platform(args.platform)))
    pkls = sorted(glob.glob(osp.join(args.results, "**/*.pkl"),
                            recursive=True))
    if not pkls:
        raise FileNotFoundError(f"no result pickles under {args.results}")
    os.makedirs(args.out, exist_ok=True)
    written = []
    for pkl in pkls:
        frame = osp.basename(osp.dirname(pkl))
        img = None
        if args.images:
            for ext in (".jpg", ".png", ".jpeg"):
                cand = osp.join(args.images, frame + ext)
                if osp.exists(cand):
                    img = load_image(cand)
                    break
        overlay = render_result_pickle(pkl, model, img=img)
        out_path = osp.join(args.out, frame + "_overlay.png")
        Image.fromarray(overlay).save(out_path)
        print(out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
