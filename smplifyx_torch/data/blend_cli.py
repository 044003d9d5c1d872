"""Keypoint-blending CLI (the Keypoints_Blending notebook flow as a command);
the port's copy of `smplifyx_tpu/data/blend_cli.py`.

    python -m smplifyx_torch.data.blend_cli --images imgs/ \
        --openpose op_json/ --mmpose mm_json/ --out blended/ \
        --heuristics heuristics/
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--openpose", required=True,
                   help="folder of <img>_keypoints.json (OpenPose BODY_25)")
    p.add_argument("--mmpose", required=True,
                   help="folder of <img>_mmpose.json (Halpe-26 layout)")
    p.add_argument("--out", required=True)
    p.add_argument("--heuristics", required=True,
                   help="folder with {openpose,mmpose}_{means,stds}.json")
    args = p.parse_args(argv)

    from smplifyx_torch.data.blending import blend_directory

    written = blend_directory(
        args.images, args.openpose, args.mmpose, args.out, args.heuristics
    )
    for path in written:
        print(path)
    print(f"blended {len(written)} frame(s)")


if __name__ == "__main__":
    main()
