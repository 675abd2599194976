"""NM in the end-to-end parity tests against the JAX package.

The Pallas traceback kernel counts some mismatches of a diagonal run
longer than 127 rows twice (the port counts each once: ROADMAP,
deliberate differences).  So the JAX runs take the kernel with its NM
output set to -1 (``no_kernel_nm``): the JAX host epilogue then recounts
a primary's NM from its cigar and the reference
(speedseq_tpu/align/emit.py:_host_nm), and a secondary's, which XA
carries.  An XA entry of the compacted extra lanes gets max(0, kernel
NM), so 0 there.  ``assert_record_equal`` holds the port's XA NM to an
edit-distance recount from the entry's cigar and the reference (JAX's to
0 or that recount), and every other field of the two records to
equality."""

import re

import jax.numpy as jnp
import numpy as np

from speedseq_tpu_torch.formats.fasta import FastaFile

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i


def no_kernel_nm(kernel):
    """``sw_pallas_cigar`` in interpret mode with its NM output -1."""
    def run(*a, interpret=False, **k):
        out = kernel(*a, interpret=True, **k)
        return (*out[:-1], jnp.full_like(out[-1], -1))
    return run


class Genome:
    """The reference's contigs as base codes (A0 C1 G2 T3, else 4)."""

    def __init__(self, fasta: str):
        self._fa = FastaFile(fasta)
        self._seqs = {}

    def __getitem__(self, chrom):
        if chrom not in self._seqs:
            self._seqs[chrom] = self._fa.fetch_encoded(chrom)
        return self._seqs[chrom]


def _revcomp(codes):
    return np.where(codes < 4, 3 - codes, 4)[::-1]


def edit_distance(query, cigar: str, ref, pos0: int) -> int:
    """Mismatches over the M ops (a base outside ACGT on either side
    counts as one) plus the bases of the I and D ops."""
    qi, ri, nm = 0, pos0, 0
    for n, op in re.findall(r"(\d+)([MIDSH])", cigar):
        n = int(n)
        if op == "S":
            qi += n
        elif op == "M":
            a, b = query[qi:qi + n], ref[ri:ri + n].astype(np.int64)
            nm += int(((a != b) | (a > 3) | (b > 3)).sum())
            qi, ri = qi + n, ri + n
        elif op == "I":
            nm, qi = nm + n, qi + n
        elif op == "D":
            nm, ri = nm + n, ri + n
    return nm


def _xa_entries(value: str):
    return [e.split(",") for e in value.split(";") if e]


def assert_record_equal(jax_rec, port_rec, genome: Genome):
    """Equal records but for XA's NM: the port writes the edit distance of
    the entry's cigar, JAX that recount or, for an extra lane whose kernel
    NM was withheld, 0."""
    a, b = jax_rec, port_rec
    ctx = (b.qname, b.flag)
    for f in ("qname", "flag", "tid", "pos", "mapq", "cigar", "mtid", "mpos",
              "tlen", "seq", "qual"):
        assert getattr(a, f) == getattr(b, f), (f,) + ctx
    assert [t[:2] for t in a.tags] == [t[:2] for t in b.tags], ctx
    for (tag, _, va), (_, _, vb) in zip(a.tags, b.tags):
        if tag != "XA":
            assert va == vb, (tag,) + ctx
            continue
        ja, jb = _xa_entries(va), _xa_entries(vb)
        assert [e[:3] for e in ja] == [e[:3] for e in jb], ctx
        read = _CODE[np.frombuffer(b.seq.encode(), np.uint8)].astype(
            np.int64)
        if b.flag & 0x10:
            read = _revcomp(read)
        for (chrom, spos, cig, nm), ej in zip(jb, ja):
            q = read if spos[0] == "+" else _revcomp(read)
            want = edit_distance(q, cig, genome[chrom], int(spos[1:]) - 1)
            assert int(nm) == want, ctx
            assert int(ej[3]) in (0, want), ctx
