"""ctypes bindings for the native keypoint parser
(smplifyx_torch/csrc/keypoint_parser.cpp).

The port of `smplifyx_tpu/data/native.py`.  The parser reads OpenPose JSONs
without building a Python object tree, for inputs of thousands of frames;
the Python reader (data/keypoints.py) stays the semantic reference and
reads every file that carries a gender annotation.  The library is built
at first use with the host C++ compiler into `build/libkeypoints_torch.so`
(ops/nvcc.py, `HOST_SOURCES`), not from the JAX package's csrc/.
"""

from __future__ import annotations

import ctypes

import numpy as np

from smplifyx_torch.ops import nvcc

LIBRARY = "keypoints_torch"
_SIGNATURES = {
    "parse_openpose_json": [ctypes.c_char_p, ctypes.c_long,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)],
    "parse_openpose_file": [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)],
}
_MAX_PEOPLE = 16
_MAX_FLOATS_PER_PERSON = (30 + 21 + 21 + 70) * 3  # generous upper bound


def load() -> ctypes.CDLL:
    """The parser library, built if stale; raises with the compiler's
    output when it cannot be built."""
    return nvcc.load(LIBRARY, _SIGNATURES)


def is_available() -> bool:
    """Whether the parser builds and loads on this host (the choice of
    `use_native_parser=None`)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def read_keypoints_native(
    keypoint_fn: str,
    use_hands: bool = True,
    use_face: bool = True,
    use_face_contour: bool = False,
) -> np.ndarray:
    """Native-parsed equivalent of data.keypoints.read_keypoints -> [P, K, 3].

    Same row layout: body, [lhand, rhand], [face rows 17:68, [rows 0:17]].
    """
    lib = load()
    cap = _MAX_PEOPLE * _MAX_FLOATS_PER_PERSON
    buf = np.empty(cap, np.float32)
    body_len = ctypes.c_int(0)
    face_len = ctypes.c_int(0)
    n = lib.parse_openpose_file(
        keypoint_fn.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(body_len), ctypes.byref(face_len))
    if n < 0:
        raise ValueError(f"native parse failed for {keypoint_fn}")

    nb, nf = body_len.value, face_len.value
    per = (nb + 42 + nf) * 3
    people = []
    for p in range(n):
        row = buf[p * per:(p + 1) * per].reshape(-1, 3)
        parts = [row[:nb]]
        if use_hands:
            parts += [row[nb:nb + 21], row[nb + 21:nb + 42]]
        if use_face:
            face = row[nb + 42:]
            parts.append(face[17:17 + 51])
            if use_face_contour:
                parts.append(face[:17])
        people.append(np.concatenate(parts, axis=0))
    return (np.stack(people) if people
            else np.zeros((0, 0, 3), np.float32))
