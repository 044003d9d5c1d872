"""Gender selection for body-model choice.

The reference optionally runs the external Homogenus TensorFlow classifier
per image (main.py:197-200, 258-271) to pick between the male/female/neutral
SMPL-X models; keypoint JSONs may also carry gender_gt/gender_pd annotations
(data_parser.py:96-99).

The port's copy of `smplifyx_tpu/data/gender.py`.  Resolution order:
explicit annotation (gender_gt, then gender_pd) -> a pluggable classifier
callable -> the configured default.  Homogenus itself is TensorFlow and
outside the fit; `load_homogenus` is the integration hook that raises with
instructions unless the optional dependency and checkpoint are available.
"""

from __future__ import annotations

from typing import Optional, Protocol

from smplifyx_torch.data.keypoints import FrameRecord

VALID = ("male", "female", "neutral")


class GenderClassifier(Protocol):
    def __call__(self, record: FrameRecord) -> str: ...


def resolve_gender(
    record: FrameRecord,
    default: str = "neutral",
    classifier: Optional[GenderClassifier] = None,
) -> str:
    for source in (record.gender_gt, record.gender_pd):
        if source:
            g = str(source[0]).lower()
            if g in VALID:
                return g
    if classifier is not None:
        g = str(classifier(record)).lower()
        if g in VALID:
            return g
    return default


def load_homogenus(ckpt_dir: str) -> GenderClassifier:
    """Load the Homogenus gender classifier if its optional stack exists.

    Raises ImportError with guidance otherwise — TensorFlow is not part of
    this framework's dependency set.
    """
    try:
        from homogenus.homogenus.tf.homogenus_infer import Homogenus_infer
    except ImportError as e:
        raise ImportError(
            "Homogenus gender classification needs the external 'homogenus' "
            "package (TensorFlow). Install it and pass its checkpoint dir, "
            "or provide gender_gt/gender_pd in the keypoint JSONs, or set "
            "cfg.gender explicitly."
        ) from e

    inferer = Homogenus_infer(ckpt_dir)
    return homogenus_classifier(inferer)


def homogenus_classifier(inferer) -> GenderClassifier:
    """Wrap a Homogenus-API inferer as a per-record classifier.

    The reference calls `predict_gender_one_img(img_dir=img_path,
    keypoints_dir=keypoint_path)` with the image path and the *keypoint JSON*
    path (main.py:258-271); FrameRecord carries both.  Split out from
    load_homogenus so tests can exercise the hook with a fake inferer
    without the TensorFlow stack.
    """

    def classify(record: FrameRecord) -> str:
        if record.keyp_path is None:
            # Fail loudly rather than silently feeding the image path as the
            # keypoint JSON path (the exact reference-API misuse this module
            # exists to avoid).
            raise ValueError(
                "homogenus_classifier needs FrameRecord.keyp_path (the "
                f"keypoint JSON path) but it is None for {record.img_path}; "
                "construct records through the dataset reader or set "
                "keyp_path explicitly."
            )
        return inferer.predict_gender_one_img(
            img_dir=record.img_path, keypoints_dir=record.keyp_path
        )

    return classify


def group_by_gender(
    records,
    default: str = "neutral",
    classifier: Optional[GenderClassifier] = None,
) -> dict[str, list]:
    """Partition frames by resolved gender (one fit batch per gender)."""
    groups: dict[str, list] = {}
    for rec in records:
        g = resolve_gender(rec, default=default, classifier=classifier)
        groups.setdefault(g, []).append(rec)
    return groups
