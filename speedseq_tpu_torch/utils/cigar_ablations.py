"""Ablated copies of the traceback DP's CUDA source, to time its parts on
the card with ``chip_smoke.py --against DIR --ablate DIR ...``.

    python -m speedseq_tpu_torch.utils.cigar_ablations SRC OUT

SRC is a ``sw_unbanded.cu`` whose ``sw_unbanded_cigar_kernel`` stores its
code table as ``codes[i * 32 + t]`` (one 32-bit word a thread a row, in
dynamic shared memory, ``Lq * 32 * 4`` bytes a block) and walks it after
the forward pass, as the kernel of commit 0b69706 does.  For each
ablation it writes ``OUT/<name>/sw_unbanded.cu``:

- ``forward_only``: the walk cut (the code table still stored, and one
  word of it read into ``n_ops`` so that the stores stay live);
- ``forward_no_store``: the walk cut and the row's word folded into a
  register instead of stored (the xor of a thread's words, or-ed over the
  warp and compared with a constant into ``n_ops``, so that no bit of a
  code is dead);
- ``few_rows``: the table cut to 8 rows (row ``i & 7``, 1,024 bytes a
  block), so that registers, not shared memory, cap the blocks an SM
  holds; the walk runs on the wrapped rows;
- ``few_rows_forward_only``: both of the first and third.

The scan kernels are not touched.  Outputs of an ablation are not the
kernel's: the smoke times them but does not hold them to the twin.
"""

from __future__ import annotations

import os
import sys

KEEP = "out[5 * stride + lane] = kop;"
STORE = "codes[i * 32 + t] = word;"
WALK = "if (bs > 0) {"
SMEM = "const size_t smem = (size_t)Lq * 32 * sizeof(unsigned);"
BEST = "int bs = 0, bi = 0, bj = 0, gs = 0, gj = 0;"
READS = ("codes[ii * 32 + (jj >> 3)]", "codes[ii * 32 + t]")


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"expected one {old!r} in the source")
    return text.replace(old, new)


def ablations(src: str) -> dict:
    """{name: the ablated source text} for the source text ``src``."""
    cut = _sub(src, WALK, "if (false) {")
    forward_only = _sub(cut, KEEP, "out[5 * stride + lane] = kop + (int)("
                        "codes[bi * 32 + (bj >> 3)] & 1u);")
    no_store = _sub(_sub(cut, STORE, "kept ^= word;"), BEST,
                    BEST + " unsigned kept = 0;")
    no_store = _sub(no_store, KEEP, "out[5 * stride + lane] = kop + (int)("
                    "__reduce_or_sync(FULL, kept) == 0x9e3779b9u);")

    def few(text):
        text = _sub(text, STORE, "codes[(i & 7) * 32 + t] = word;")
        for r in READS:
            if r in text:
                text = _sub(text, r, r.replace("ii * 32", "(ii & 7) * 32"))
        if "codes[bi * 32" in text:
            text = _sub(text, "codes[bi * 32", "codes[(bi & 7) * 32")
        return _sub(text, SMEM, "const size_t smem = (size_t)min(Lq, 8) * "
                    "32 * sizeof(unsigned);")

    return {"forward_only": forward_only, "forward_no_store": no_store,
            "few_rows": few(src), "few_rows_forward_only": few(forward_only)}


def main(argv=None) -> int:
    src, out = (argv or sys.argv[1:])[:2]
    with open(src) as fh:
        text = fh.read()
    for name, body in ablations(text).items():
        os.makedirs(os.path.join(out, name), exist_ok=True)
        with open(os.path.join(out, name, "sw_unbanded.cu"), "w") as fh:
            fh.write(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
