"""Batched decode serving demo (reduced config): ``launch.serve`` with the
reference example's arguments, on the card unless ``--device cpu`` is
given (further arguments go to ``launch.serve``).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import sys

from repro_torch.launch.serve import main as serve


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = serve(["--arch", "qwen2_0_5b", "--batch", "4", "--cache-len", "128", "--tokens", "24",
                 *argv])
    assert out["tokens"].shape == (4, 24)
    print("example OK")
    return out


if __name__ == "__main__":
    main()
