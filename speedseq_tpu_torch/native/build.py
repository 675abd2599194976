"""Ahead-of-time native runtime build: ``python -m speedseq_tpu_torch.native.build``.

The reference builds its native engines via Makefile targets
(Makefile:43-51); here the single C++ runtime (csrc/ssq_native.cc —
BGZF codec, BAM record codec, columnar record assembly, aux-tag
scanners) is compiled with the same g++ invocation the first use in a
process makes, so this is just the eager form of that build.
"""

from __future__ import annotations

import sys

from . import _build, load


def main() -> int:
    try:
        load()
    except RuntimeError as e:
        print(f"{e}\nthe port cannot run without its native runtime "
              "(g++ and zlib)", file=sys.stderr)
        return 1
    print(f"built {_build()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
