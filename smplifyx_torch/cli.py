"""Command-line entry: python -m smplifyx_torch.cli --config cfg/preset.yaml ...

The JAX package's `smplifyx_tpu.cli` on the port: a YAML preset plus
`--key value` overrides of any config field (reference `python
smplifyx/main.py --config ...`, main.py:326-328).  The fit runs on the
card; `--platform cpu` runs it on the CPU.
"""

from __future__ import annotations

from smplifyx_torch.app import run
from smplifyx_torch.utils.config import parse_cli


def main(argv=None):
    """Run the app on the parsed flags; returns its AppResult."""
    return run(parse_cli(argv))


if __name__ == "__main__":
    main()
