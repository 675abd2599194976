"""The port's CUDA kernels against their plain twins, and FM seeding's,
var's, sv's, somatic's and realign's device paths on cuda against cpu, on
the card
(marked ``gpu``; they skip without a CUDA device and count as not run).
Run on a
machine with a card (the conftest imports jax, so leave it out there):
python -m pytest --noconftest -m gpu tests/test_torch_gpu.py"""

import os

import numpy as np
import pytest
import torch

from speedseq_tpu_torch.ops import sv_cluster, sw_banded
from speedseq_tpu_torch.utils import sv_cases
from speedseq_tpu_torch.utils.sw_cases import (sw_cap_cases, sw_edge_cases,
                                               sw_long_run_cases)

pytestmark = pytest.mark.gpu


def _need_card():
    # decided inside the test, so every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")


BWA, CHEAP_GAP, NO_INT8 = (1, 4, 6, 1), (1, 4, 1, 1), (200, 300, 6, 1)


def _random_cases(n, Lq, Lr, seed):
    """Random codes 0-4 with a third of the windows holding 200 bases of
    their query (band column 20), and qlen from -2 to Lq + 3."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, Lq)).astype(np.int32)
    r = rng.integers(0, 5, (n, Lr)).astype(np.int32)
    r[1::3, 30:230] = q[1::3, 10:210]
    return q, rng.integers(-2, Lq + 4, n).astype(np.int32), r


@pytest.mark.parametrize("n,Lq,Lr,params,cases,seed", [
    (4096, 151, 256, BWA, "edge", 4096),
    (1000, 112, 256, CHEAP_GAP, "edge", 1000), (3, 151, 256, BWA, "edge", 3),
    (16384, 151, 256, BWA, "edge", 16535), (1024, 151, 256, BWA, "edge", 1175),
    (256, 151, 256, BWA, "edge", 407),
    (16384, 150, 256, BWA, "edge", 16534), (1024, 150, 256, BWA, "edge", 1174),
    (256, 150, 256, BWA, "edge", 406),
    (320, 256, 256, BWA, "random", 576),
    (320, 256, 256, CHEAP_GAP, "random", 576),
    (320, 256, 256, BWA, "long", 576), (320, 256, 256, CHEAP_GAP, "long", 576),
    (320, 256, 256, NO_INT8, "long", 576)],
    ids=["4096", "cheap-gap", "3-lanes", "extend-16384x151", "xa-1024x151",
         "rescue-256x151", "width-150-16384", "width-150-1024",
         "width-150-256", "256x256", "256x256-cheap-gap", "long-runs",
         "long-runs-cheap-gap", "long-runs-no-int8-table"])
def test_cigar_kernel_matches_twin(n, Lq, Lr, params, cases, seed):
    """All 11 outputs bit-equal to the twin: the edge cases, the main
    path's three launches (extend_candidates, _extend_xa and the mate
    rescue's extension, each 151 x 256: align/core.py pads the reads by
    one) and the same lane counts at a width of 150, Lq = Lr = 256 (random
    codes with N and qlen from -2 to 259, and chains longer than 127
    rows), with bwa scoring, cheap gaps, and scores past the int8 table."""
    _need_card()
    make = {"edge": sw_edge_cases, "random": _random_cases,
            "long": sw_long_run_cases}[cases]
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in make(n, Lq, Lr, seed=seed))
    before = sw_banded.LAUNCHES["sw_cigar"]
    got = sw_banded.sw_cigar(q, ql, r, params)
    torch.cuda.synchronize()
    assert sw_banded.LAUNCHES["sw_cigar"] == before + 1
    want = sw_banded.sw_cigar_plain(q, ql, r, params)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n,Lq", [(768, 151), (5, 112)])
def test_score_kernel_matches_twin(n, Lq):
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_edge_cases(n, Lq, 256, seed=n))
    before = sw_banded.LAUNCHES["sw_score"]
    got = sw_banded.sw_score(q, ql, r)
    torch.cuda.synchronize()
    assert sw_banded.LAUNCHES["sw_score"] > before
    for a, b in zip(got, sw_banded.sw_score_plain(q, ql, r)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n,Lq,Lr,params", [
    (768, 150, 256, (1, 4, 6, 1)), (768, 150, 254, (1, 4, 6, 1)),
    (32768, 151, 256, (1, 4, 6, 1)), (768, 151, 256, (200, 300, 6, 1))],
    ids=["rescue-150x256", "window-150x254", "phase1-32768",
         "no-int8-table"])
def test_score_kernel_matches_twin_at_path_shapes(n, Lq, Lr, params):
    """The main path's rescue shape (a 254-column window padded to 256),
    a window width that is no multiple of 4, 32,768 lanes (every chain of
    an 8,192-read batch end), and scores that do not fit the kernel's int8
    table."""
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_edge_cases(n, Lq, Lr, seed=n + Lr))
    got = sw_banded.sw_score(q, ql, r, params)
    for a, b in zip(got, sw_banded.sw_score_plain(q, ql, r, params)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("params", [(1, 4, 6, 1), (1, 4, 1, 1)])
def test_score_kernel_cap_cases(params):
    """Deletions of 62-66 bases, at the deletion window's cap."""
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_cap_cases(768, 151, 256, seed=3))
    got = sw_banded.sw_score(q, ql, r, params)
    for a, b in zip(got, sw_banded.sw_score_plain(q, ql, r, params)):
        assert torch.equal(a.cpu(), b.cpu())


def test_score_kernel_odd_lengths():
    """Lq = Lr = 256 (the table's last row, the window's right end), and
    qlen above Lq, zero or negative, on random codes with N."""
    _need_card()
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.integers(0, 5, (96, 256)).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, 5, (96, 256)).astype(np.int32))
    r[1::3, :100] = q[1::3, 20:120]
    ql = torch.from_numpy(rng.integers(-2, 260, 96).astype(np.int32))
    got = sw_banded.sw_score(q.cuda(), ql.cuda(), r.cuda())
    for a, b in zip(got, sw_banded.sw_score_plain(q, ql, r)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("params", [(1, 4, 6, 1), (200, 300, 6, 1)],
                         ids=["int8-table", "compares"])
def test_kernels_on_out_of_range_ref_codes(params):
    """Ref codes below 0 (a mismatch against every base) and above 4 (N)
    give both kernels the twins' answers."""
    _need_card()
    q, ql, r = sw_edge_cases(256, 151, 256, seed=17)
    rng = np.random.default_rng(17)
    odd = rng.random(r.shape) < 0.1
    r[odd] = rng.choice(np.array([-7, -1, 5, 9], np.int32), int(odd.sum()))
    q, ql, r = (torch.from_numpy(a) for a in (q, ql, r))
    got = sw_banded.sw_score(q.cuda(), ql.cuda(), r.cuda(), params)
    for a, b in zip(got, sw_banded.sw_score_plain(q, ql, r, params)):
        assert torch.equal(a.cpu(), b)
    got = sw_banded.sw_cigar(q.cuda(), ql.cuda(), r.cuda(), params)
    for a, b in zip(got, sw_banded.sw_cigar_plain(q, ql, r, params)):
        assert torch.equal(a.cpu(), b)


def test_cigar_kernel_one_launch_past_16384_lanes():
    """20,000 lanes in one launch (the kernel keeps no scratch in device
    memory, so nothing bounds the lanes of a launch), bit-equal to the
    twin."""
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_edge_cases(20000, 151, 256, seed=7))
    before = sw_banded.LAUNCHES["sw_cigar"]
    got = sw_banded.sw_cigar(q, ql, r)
    torch.cuda.synchronize()
    assert sw_banded.LAUNCHES["sw_cigar"] == before + 1
    for a, b in zip(got, sw_banded.sw_cigar_plain(q, ql, r)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("seed", [0, 1])
def test_hap_scan_cuda_matches_cpu(seed):
    """var's haplotype scan: all five outputs equal on cuda and cpu,
    including first-maximum ties (two-letter lanes)."""
    _need_card()
    from speedseq_tpu_torch.align.sw import banded_sw_score
    from speedseq_tpu_torch.utils.var_cases import hap_scan_lanes

    lanes = [torch.from_numpy(a) for a in hap_scan_lanes(seed)]
    cpu = banded_sw_score(*lanes)
    gpu = banded_sw_score(*(t.cuda() for t in lanes))
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)
    ties = torch.tensor([[3, 7, 7, 1, 7]], device="cuda")
    assert int(torch.max(ties, dim=1).indices) == 1
    assert int(torch.argmax(ties, dim=1)) == 1


@pytest.mark.parametrize("Lq,Lr,params", [
    (150, 192, BWA), (250, 320, BWA), (300, 1024, BWA), (150, 200, BWA),
    (250, 320, CHEAP_GAP), (180, 256, BWA), (1000, 1088, BWA),
    (300, 2112, BWA), (300, 4160, CHEAP_GAP), (64, 20000, BWA),
    (64, 32768, BWA), (1, 192, BWA), (256, 320, BWA), (257, 320, BWA),
    (257, 1088, CHEAP_GAP), (2100, 2200, BWA), (300, 32768, BWA),
    (2100, 20000, CHEAP_GAP)],
    ids=["150x192", "250x320", "300x1024", "150x200-pad",
         "250x320-cheap-gap", "180x256-long-deletions", "wide-1000x1088",
         "wide-300x2112", "wide-300x4160-cheap-gap",
         "wide-64x20000-device-memory-row", "wide-64x32768-width-limit",
         "Lq-1", "one-stripe-256x320", "stripe-and-a-row-257x320",
         "wide-stripe-and-a-row-257x1088", "wide-2100x2200-two-passes",
         "wide-300x32768-device-scratch",
         "wide-2100x20000-device-scratch-two-passes"])
def test_unbanded_kernel_matches_twin(Lq, Lr, params):
    """ssq_sw_unbanded_score against its twin on the card, all five
    outputs bit-equal: var's shape (150 x 192), 250 bp reads (250 x 320),
    the widest narrow window, a width with padding columns, cheap gaps,
    deletions past the Pallas cap (utils/var_cases.unbanded_lanes), Lq 1,
    Lq not a multiple of 32 R (150, 1000, 2100), a stripe boundary (Lq =
    32 R = 256 and 257: a second stripe of one row), and the wide entry:
    1,000 bp reads (1088), 2112 and 4160, 9 stripes on 8 warps (two
    passes) at 2200 and 20,000, 20,000 and 32,768 (the width limit at bwa
    scoring) with one stripe (no buffer) and with several (stripe buffers
    in a device scratch where a block cannot hold them)."""
    _need_card()
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import unbanded_lanes

    if Lq > 1:
        host = unbanded_lanes(Lq, Lr, seed=Lq + Lr)
    else:                  # codes -1..5, qlen -1..2
        rng = np.random.default_rng(Lr)
        host = (rng.integers(-1, 6, (64, Lq)).astype(np.int32),
                rng.integers(-1, 3, 64).astype(np.int32),
                rng.integers(-1, 6, (64, Lr)).astype(np.int32))
    q, ql, r = (torch.from_numpy(a).cuda() for a in host)
    before = sw_unbanded.LAUNCHES["sw_unbanded_score"]
    got = sw_unbanded.sw_score_unbanded(q, ql, r, params)
    torch.cuda.synchronize()
    assert sw_unbanded.LAUNCHES["sw_unbanded_score"] == before + 1
    want = sw_unbanded.sw_score_unbanded_plain(q, ql, r, params)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("R,warps", [(8, 1), (8, 2), (8, 8), (4, 8),
                                     (6, 4), (3, 8), (2, 8)])
def test_unbanded_scan_layouts_match_twin(R, warps):
    """The wide entry at layouts other than scan_layout's (rows a thread,
    warps a block: one warp running every stripe through its own buffer,
    more warps than stripes) on 1,000 bp reads (1000 x 1088), bit-equal
    to the twin."""
    _need_card()
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import unbanded_lanes

    q, ql, r = (torch.from_numpy(a).cuda()
                for a in unbanded_lanes(1000, 1088, seed=2088))
    n, Lq, Lr = q.shape[0], q.shape[1], r.shape[1]
    out = torch.empty((5, n), dtype=torch.int32, device="cuda")
    assert sum(sw_unbanded.scan_smem_bytes(Lq, Lr, R, warps)) <= \
        sw_unbanded.SMEM_MAX
    rc = sw_unbanded._load().ssq_sw_unbanded_score_wide(
        q.data_ptr(), ql.data_ptr(), r.data_ptr(), n, Lq, Lr, R, warps,
        *BWA, out.data_ptr(), n, None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = sw_unbanded.sw_score_unbanded_plain(q, ql, r, BWA)
    for a, b in zip(out, want):
        assert torch.equal(a.cpu(), b.cpu())


def test_unbanded_kernel_from_four_threads():
    """Four host threads launching the haplotype scan at once (var -t 4)
    give the outputs of one thread, each call one launch."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    from speedseq_tpu_torch.align.sw import banded_sw_score
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import hap_scan_lanes

    lanes = [[torch.from_numpy(a).cuda() for a in hap_scan_lanes(seed)]
             for seed in range(8)]
    one = [[t.cpu() for t in banded_sw_score(*x)] for x in lanes]
    before = sw_unbanded.LAUNCHES["sw_unbanded_score"]
    with ThreadPoolExecutor(4) as pool:
        four = list(pool.map(
            lambda x: [t.cpu() for t in banded_sw_score(*x)], lanes * 4))
    assert sw_unbanded.LAUNCHES["sw_unbanded_score"] == before + 32
    for k, got in enumerate(four):
        for a, b in zip(got, one[k % 8]):
            assert torch.equal(a, b)


def test_unbanded_kernel_refuses_what_it_cannot_take():
    """On a CUDA tensor the wrapper raises past the width limit (32,768 at
    bwa scoring), for Lq > Lr and for gap penalties below 0, launching
    nothing (no fallback to the twin), and takes every width below: var's call_window on cuda, on a
    window of 1,000 bp reads (Lr 1088: the wide kernel, one launch), gives
    the CPU twin's calls (tests/test_torch_var.py's long-reads-mnp
    window)."""
    _need_card()
    from speedseq_tpu_torch.formats.sam import SAMRecord
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.var import caller
    from speedseq_tpu_torch.var.pileup import build_pileup

    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")
    before = dict(sw_unbanded.LAUNCHES)
    with pytest.raises(ValueError, match="Lr <= 32768"):
        sw_unbanded.sw_score_unbanded(z(2, 150), z(2), z(2, 32769))
    with pytest.raises(ValueError, match="Lq <= Lr"):
        sw_unbanded.sw_score_unbanded(z(2, 150), z(2), z(2, 149))
    with pytest.raises(ValueError, match="gap open and extension >= 0"):
        sw_unbanded.sw_score_unbanded(z(2, 150), z(2), z(2, 192),
                                      (1, 4, -1, 1))
    assert sw_unbanded.LAUNCHES == before
    g = np.random.default_rng(13).integers(0, 4, 1000).astype(np.uint8)
    ref = "".join("ACGT"[c] for c in g)
    alt = (ref[:500] + "".join("ACGT"[(c + 1) % 4] for c in g[500:502])
           + ref[502:])
    recs = [(SAMRecord(qname=f"r{i}", flag=16 if i % 2 else 0, tid=0,
                       pos=0, mapq=60, cigar=[(0, 1000)], mtid=-1, mpos=-1,
                       tlen=0, seq=alt if i < 6 else ref, qual="I" * 1000),
             0) for i in range(12)]
    calls = {}
    for dev in ("cpu", "cuda"):
        n0 = sw_unbanded.LAUNCHES["sw_unbanded_score"]
        calls[dev] = caller.call_window(
            g, build_pileup(recs, 0, len(g)), 1,
            caller.CallerConfig(min_alternate_fraction=0.1), device=dev)
        launched = sw_unbanded.LAUNCHES["sw_unbanded_score"] - n0
        assert launched == (1 if dev == "cuda" else 0)
    assert len(calls["cuda"]) == len(calls["cpu"]) == 1
    assert calls["cuda"][0].alts == [alt[500:502]]
    for a, b in zip(calls["cuda"], calls["cpu"]):
        assert (a.offset, a.ref, a.alts, a.types, a.lengths) == (
            b.offset, b.ref, b.alts, b.types, b.lengths)
        for f in ("gt", "gq", "dp", "ro", "ao", "qr", "qa", "rpl", "rpr",
                  "saf", "sar"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        np.testing.assert_allclose(a.gl, b.gl, atol=1e-4, rtol=0)
        assert a.qual == pytest.approx(b.qual, abs=1e-4)


@pytest.mark.parametrize("Lq,Lr,params,n", [
    (100, 204, BWA, 0), (100, 204, CHEAP_GAP, 0), (100, 204, (1, 4, 6, 0), 0),
    (150, 254, BWA, 0), (150, 254, CHEAP_GAP, 0), (150, 254, (1, 4, 6, 0), 0),
    (150, 254, BWA, 32768), (300, 200, BWA, 64), (1792, 256, CHEAP_GAP, 8)],
    ids=["100x204", "100x204-cheap-gap", "100x204-ext-0", "150x254",
         "150x254-cheap-gap", "150x254-ext-0", "slice-32768x150x254",
         "query-longer-300x200", "1792x256-most-shared-memory"])
def test_unbanded_cigar_kernel_matches_twin(Lq, Lr, params, n):
    """ssq_sw_unbanded_cigar against its twin on the card, all ten
    outputs bit-equal: utils/var_cases.cigar_lanes (all-zero lanes,
    qlen 0, 1 and Lq, codes -1, 4 and 5, two-letter ties, deletions of
    65..200 columns, I-runs, more than 48 ops), the slice's launch
    (32,768 lanes of the edge cases at 150 x 254), a query longer than its
    window, and the tallest query the shared-memory code table holds."""
    _need_card()
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import cigar_lanes

    rng = np.random.default_rng(n)
    if n == 0:
        host = cigar_lanes(Lq, Lr, seed=Lq + Lr)
    elif Lq <= Lr:
        host = sw_edge_cases(n, Lq, Lr, seed=n)
    else:     # random codes 0-4, every other window holding 180 query bases
        q = rng.integers(0, 5, (n, Lq)).astype(np.int32)
        r = rng.integers(0, 5, (n, Lr)).astype(np.int32)
        r[1::2, 10:190] = q[1::2, 50:230]
        host = q, rng.integers(-2, Lq + 4, n).astype(np.int32), r
    q, ql, r = (torch.from_numpy(a).cuda() for a in host)
    before = sw_unbanded.LAUNCHES["sw_unbanded_cigar"]
    got = sw_unbanded.sw_cigar_unbanded(q, ql, r, params)
    torch.cuda.synchronize()
    assert sw_unbanded.LAUNCHES["sw_unbanded_cigar"] == before + 1
    want = sw_unbanded.sw_cigar_unbanded_plain(q, ql, r, params)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if n == 0:
        assert int(want[7].max()) > 48 or params != CHEAP_GAP


@pytest.mark.parametrize("Lq,Lr,params", [
    (150, 254, BWA), (300, 200, CHEAP_GAP), (1792, 256, BWA),
    (1792, 256, CHEAP_GAP)],
    ids=["150x254", "300x200-cheap-gap", "1792x256", "1792x256-cheap-gap"])
def test_unbanded_cigar_kernel_on_long_runs(Lq, Lr, params):
    """ssq_sw_unbanded_cigar against its twin on the card, all ten
    outputs bit-equal, on utils/var_cases.cigar_run_lanes: exact
    placements whose diagonal runs are longer than 32 rows (up to 254 at
    Lq 1,792), spaced mismatches, and insertions of 6..90 bases, whose
    I-runs mode 1 carries."""
    _need_card()
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import cigar_run_lanes

    q, ql, r = (torch.from_numpy(a).cuda()
                for a in cigar_run_lanes(Lq, Lr, seed=Lq))
    before = sw_unbanded.LAUNCHES["sw_unbanded_cigar"]
    got = sw_unbanded.sw_cigar_unbanded(q, ql, r, params)
    torch.cuda.synchronize()
    assert sw_unbanded.LAUNCHES["sw_unbanded_cigar"] == before + 1
    want = sw_unbanded.sw_cigar_unbanded_plain(q, ql, r, params)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    ops, lens = want[5].cpu(), want[6].cpu()
    assert int(torch.where(ops == 0, lens, 0).max()) > 32
    assert int(torch.where(ops == 1, lens, 0).max()) >= 6


def test_unbanded_cigar_kernel_refuses_what_it_cannot_take():
    """On a CUDA tensor the traceback DP raises for Lr > 256 (as on the
    CPU: the deletion distance is a uint8), for Lq > 1792 (the kernel's
    code table in shared memory) and for max_ops > 64, launching
    nothing."""
    _need_card()
    from speedseq_tpu_torch.ops import sw_unbanded

    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")
    before = dict(sw_unbanded.LAUNCHES)
    with pytest.raises(ValueError, match="Lr <= 256"):
        sw_unbanded.sw_cigar_unbanded(z(2, 150), z(2), z(2, 257))
    with pytest.raises(ValueError, match="Lq <= 1792"):
        sw_unbanded.sw_cigar_unbanded(z(2, 1793), z(2), z(2, 256))
    with pytest.raises(ValueError, match="max_ops <= 64"):
        sw_unbanded.sw_cigar_unbanded(z(2, 150), z(2), z(2, 256),
                                      max_ops=65)
    assert sw_unbanded.LAUNCHES == before


@pytest.mark.parametrize("kind,n,trim", [
    ("pile", 4096, 0.0), ("random", 400, 0.0), ("random", 400, 0.01)],
    ids=["pile-4096", "random-400", "random-400-trim"])
def test_combine_kernel_matches_twin(kind, n, trim, monkeypatch):
    """ssq_sv_combine_logsum against its twin on the card, bit-equal, on
    the inputs cluster_and_combine gives it (one launch a side), and the
    whole combination on cuda equal to cpu (ints equal, curves within
    2e-5)."""
    _need_card()
    from speedseq_tpu_torch.ops import sv_combine
    from speedseq_tpu_torch.sv import device as sd
    from speedseq_tpu_torch.sv.cluster import evidence_columns

    rng = np.random.default_rng(n)
    ev = (sv_cases.pile_evidence(rng, n) if kind == "pile"
          else sv_cases.random_evidence(rng, n))
    cols = evidence_columns(ev)[1:]
    seen, real = [], sv_combine.combine_logsum
    monkeypatch.setattr(sv_combine, "combine_logsum",
                        lambda *a: (seen.append(a), real(*a))[1])
    before = sv_combine.LAUNCHES["sv_combine_logsum"]
    gpu = sd.cluster_and_combine(*cols, trim, device="cuda")
    assert sv_combine.LAUNCHES["sv_combine_logsum"] == before + 2
    monkeypatch.undo()
    for a in seen:
        got = real(*a)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           sv_combine.sv_combine_logsum_plain(*a).cpu())
    cpu = sd.cluster_and_combine(*cols, trim, device="cpu")
    for k in (0, 1):
        for f in ("pos", "ci", "ci95", "nz"):
            assert np.array_equal(getattr(gpu, f)[k], getattr(cpu, f)[k])
        np.testing.assert_allclose(gpu.prob[k], cpu.prob[k], atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("case", sorted(sv_cases.COMBINE_EDGES))
def test_combine_kernel_matches_twin_at_chunk_edges(case):
    """ssq_sv_combine_logsum against its twin on the card, bit for bit (NaN
    payloads too), one launch an entry: utils/sv_cases.combine_edge_cases,
    whose
    clusters sit at the chunk edges K - 1, K, K + 1 of the 32-, 64- and
    128-column tiles the kernel picks on a 132-SM card, with an empty
    cluster, W no multiple of the tile, NaN, 0, negative, inf, denormal
    and <= 1e-12 curve cells, and a 4,096-member pile; first and sizes
    int32 and int64 (the kernel's two entries)."""
    _need_card()
    from speedseq_tpu_torch.ops import sv_combine

    a = sv_cases.combine_edge_cases(case, seed=3)
    t = [torch.from_numpy(x).cuda() for x in a[:6]]
    before = sv_combine.LAUNCHES["sv_combine_logsum"]
    got = sv_combine.combine_logsum(*t, a[6])
    # first and sizes as int64, as cluster_and_combine passes them: the
    # kernel's int64 entry
    got64 = sv_combine.combine_logsum(t[0].long(), t[1].long(), *t[2:], a[6])
    torch.cuda.synchronize()
    assert sv_combine.LAUNCHES["sv_combine_logsum"] == before + 2
    want = sv_combine.sv_combine_logsum_plain(*t, a[6])
    for g in (got, got64):
        assert torch.equal(g.view(torch.int32).cpu(),
                           want.view(torch.int32).cpu())
    assert bool(torch.isnan(want).any())


@pytest.mark.parametrize("n_samples,pooled", [(1, False), (3, False),
                                              (2, True)])
def test_genotype_sites_cuda_matches_cpu(n_samples, pooled):
    """var's genotyping program on cuda against cpu: integer outputs
    equal, GL within 1e-4, QUAL within 1e-3, GQ within 1."""
    _need_card()
    from speedseq_tpu_torch.utils.var_cases import random_sites
    from speedseq_tpu_torch.var.device import genotype_sites

    args = random_sites(5 + n_samples, 500, 300, n_samples,
                        2 if pooled else 3)
    cpu = genotype_sites(*args, 0.001, n_samples, device="cpu",
                         pooled=pooled)
    gpu = genotype_sites(*args, 0.001, n_samples, device="cuda",
                         pooled=pooled)
    for f in ("gt_idx", "dp", "ro", "ao", "qr", "qa", "rpl", "rpr", "saf",
              "sar"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))
    assert np.abs(gpu.gq.astype(int) - cpu.gq).max() <= 1
    np.testing.assert_allclose(gpu.gl, cpu.gl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gpu.qual, cpu.qual, atol=1e-3, rtol=0)
    if pooled:
        np.testing.assert_array_equal(gpu.joint.gn, cpu.joint.gn)
        np.testing.assert_array_equal(gpu.joint.gt, cpu.joint.gt)
        assert np.abs(gpu.joint.gq.astype(int) - cpu.joint.gq).max() <= 1
        np.testing.assert_allclose(gpu.joint.qual, cpu.joint.qual,
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape", sv_cases.SWEEP_SHAPES)
def test_sv_cluster_kernel_matches_twin(shape):
    _need_card()
    cols = [torch.from_numpy(c) for c in sv_cases.sweep_columns(shape, seed=3)]
    before = sv_cluster.LAUNCHES["sv_cluster"]
    got = sv_cluster.cluster_scan(*(c.cuda() for c in cols))
    torch.cuda.synchronize()
    assert sv_cluster.LAUNCHES["sv_cluster"] == before + 1
    assert torch.equal(got.cpu(), sv_cluster.cluster_scan_plain(*cols))


@pytest.mark.parametrize("case", sorted(sv_cases.sweep_adversarial()))
def test_sv_cluster_kernel_adversarial(case):
    """The sweep kernel on the inputs at the edges of its forced-break
    split (int32 limits, start1 at P and one below, gid changes after a
    huge end1, single-row segments) equal to its twin."""
    _need_card()
    cols = [torch.from_numpy(c) for c in sv_cases.sweep_adversarial()[case]]
    got = sv_cluster.cluster_scan(*(c.cuda() for c in cols))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sv_cluster.cluster_scan_plain(*cols))


def test_sv_cluster_makes_no_host_sync():
    """cluster_scan on cuda under torch's sync debug mode "error": a host
    sync in the wrapper or its launches would raise.  Both launch plans:
    one block (2,000 rows) and tiles (1,048,576 rows)."""
    _need_card()
    cases = [[torch.from_numpy(c) for c in sv_cases.sweep_columns(shape,
                                                                  seed=5)]
             for shape in ("one-group", "genome-piles")]
    dev = [[c.cuda() for c in cols] for cols in cases]
    sv_cluster.cluster_scan(*dev[0])            # builds the library
    torch.cuda.synchronize()
    before = sv_cluster.LAUNCHES["sv_cluster"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [sv_cluster.cluster_scan(*cols) for cols in dev]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sv_cluster.LAUNCHES["sv_cluster"] == before + 2
    for g, cols in zip(got, cases):
        assert torch.equal(g.cpu(), sv_cluster.cluster_scan_plain(*cols))


@pytest.mark.parametrize("seed,n,trim", [(11, 200, 0.0), (5, 60, 0.01),
                                         (23, 400, 0.0)])
def test_cluster_breakpoints_cuda_matches_cpu(seed, n, trim):
    """The sweep and both curve combinations on cuda against cpu: every
    integer field equal, PRPOS/PREND within atol 2e-5."""
    _need_card()
    from speedseq_tpu_torch.sv.cluster import cluster_breakpoints

    ev = sv_cases.random_evidence(np.random.default_rng(seed), n)
    cpu = cluster_breakpoints(ev, min_weight=1, trim=trim, device="cpu")
    gpu = cluster_breakpoints(ev, min_weight=1, trim=trim, device="cuda")
    _assert_calls_equal(gpu, cpu)


def test_cluster_breakpoints_deep_pile_cuda_matches_cpu():
    """One cluster of 2,000 members (2,000 steps of the member-rank loop)
    on cuda against cpu, under the same rules."""
    _need_card()
    from speedseq_tpu_torch.sv.cluster import cluster_breakpoints

    ev = sv_cases.pile_evidence(np.random.default_rng(41), 2000)
    cpu = cluster_breakpoints(ev, device="cpu")
    gpu = cluster_breakpoints(ev, device="cuda")
    assert len(cpu) == 1 and cpu[0].su == 2000
    _assert_calls_equal(gpu, cpu)


def _assert_calls_equal(gpu, cpu):
    assert len(gpu) == len(cpu) > 0
    for a, b in zip(gpu, cpu):
        for f in ("svtype", "tid1", "strand1", "pos1", "tid2", "strand2",
                  "pos2", "cipos", "ciend", "cipos95", "ciend95", "su", "pe",
                  "sr", "sample_support", "imprecise"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.prpos, b.prpos, atol=2e-5, rtol=0)
        np.testing.assert_allclose(a.prend, b.prend, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fixture", ["unmapped_tail_bam", "depth_tier_bam"])
def test_svtyper_cuda_matches_cpu(fixture, tmp_path):
    """The SVTyper program on cuda against cpu: counts and GT equal, GQ
    within 1, SQ within 0.05, GL within 1."""
    _need_card()
    from speedseq_tpu_torch.sv.cluster import SVCall
    from speedseq_tpu_torch.sv.evidence import InsertStats
    from speedseq_tpu_torch.sv.svtyper import SVGenotyper

    bam = str(tmp_path / "t.bam")
    calls = [SVCall(**f) for f in getattr(sv_cases, fixture)(bam)]
    st = InsertStats.synthetic(300, 50)
    cpu = SVGenotyper(bam, st, device="cpu").genotype_all(calls)
    gpu = SVGenotyper(bam, st, device="cuda").genotype_all(calls)
    for a, b in zip(gpu, cpu):
        for f in ("dp", "ro", "ao", "rs", "as_", "rp", "ap", "gt", "ab"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.gq - b.gq) <= 1 and abs(a.sq - b.sq) <= 0.05
        assert np.abs(np.subtract(a.gl, b.gl)).max() <= 1


def test_depth_programs_cuda_matches_cpu():
    """Depth bins and GC correction equal on cuda and cpu; mean-shift on
    the abrupt-boundary fixture within rtol 1e-4, the same CNV call."""
    _need_card()
    from speedseq_tpu_torch.sv import device as sd
    from speedseq_tpu_torch.sv.cnv import DepthProfile

    rng = np.random.default_rng(4)
    idx = rng.integers(0, 5001, 200_000)
    np.testing.assert_array_equal(sd.depth_bins(idx, 5001, device="cuda"),
                                  sd.depth_bins(idx, 5001, device="cpu"))
    counts = rng.poisson(60, 5000).astype(np.float64)
    strata = rng.integers(30, 60, 5000)
    valid = rng.random(5000) > 0.05
    gc, mc = sd.gc_correct(counts, strata, valid, device="cuda")
    cc, mm = sd.gc_correct(counts, strata, valid, device="cpu")
    np.testing.assert_array_equal(gc, cc)
    assert mc == mm
    x, mean = sv_cases.abrupt_profile()
    calls = {}
    for dev in ("cpu", "cuda"):
        prof = DepthProfile(bin_size=100, chroms=["c"], counts={"c": x},
                            corrected={"c": x}, mean=mean, device=dev)
        calls[dev] = ([(c.kind, c.start, c.end) for c in prof.call("c")],
                      prof.partition("c"))
    assert calls["cuda"][0] == calls["cpu"][0] == [("deletion", 15000, 25000)]
    np.testing.assert_allclose(calls["cuda"][1], calls["cpu"][1], rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pooled_joint_genotypes_cuda_matches_cpu(seed):
    """The joint [normal, tumor] combination alone: gn and gt equal, gq
    and qual within 1e-4."""
    _need_card()
    from speedseq_tpu_torch.var.caller_space import GT_PAIRS, N_GT
    from speedseq_tpu_torch.var.device import pooled_joint_genotypes

    rng = np.random.default_rng(seed)
    gl = rng.normal(0.0, 4.0, (2000, 2, N_GT)).astype(np.float32)
    n_alts = rng.integers(1, 4, 2000)
    hi = np.array([max(j, k) for j, k in GT_PAIRS])
    gl[np.broadcast_to(hi[None, None, :] > n_alts[:, None, None],
                       gl.shape)] = -1e9
    gl -= gl.max(axis=2, keepdims=True)
    cpu = pooled_joint_genotypes(gl, 0.001, device="cpu")
    gpu = pooled_joint_genotypes(gl, 0.001, device="cuda")
    np.testing.assert_array_equal(gpu.gn, cpu.gn)
    np.testing.assert_array_equal(gpu.gt, cpu.gt)
    np.testing.assert_allclose(gpu.gq, cpu.gq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gpu.qual, cpu.qual, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def tumor_normal_bams(tmp_path_factory):
    """A random 12 kbp genome, normal and tumor at 25x of 100 bp pairs
    (utils/somatic_cases.py), aligned by the port on the card."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.utils import somatic_cases

    d = tmp_path_factory.mktemp("gsom")
    case = somatic_cases.tumor_normal(12_000, 1500, 1500, seed=5,
                                      read_len=100, somatic_rate=0.002)
    fa = str(d / "s.fa")
    somatic_cases.write_fasta(fa, "s", case.genome)
    bams = {}
    for name, reads in (("normal", case.normal), ("tumor", case.tumor)):
        f1, f2 = somatic_cases.write_fastqs(str(d / name), reads)
        sm = name.upper()
        align_fastq(fa, f1, f2, out_prefix=str(d / name),
                    config=AlignConfig(batch_size=512, rg_string=(
                        f"@RG\\tID:{sm[0]}\\tSM:{sm}")), device="cuda")
        bams[name] = str(d / f"{name}.bam")
    return d, fa, bams


def test_somatic_cuda_matches_cpu(tumor_normal_bams):
    """run_somatic on cuda against cpu: the records equal under the var
    rules (GL and QUAL within 0.01, GQ within 1, SSC within 0.03), the
    PED files equal."""
    _need_card()
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.utils.somatic_cases import records_mismatch
    from speedseq_tpu_torch.var.somatic import run_somatic

    d, fa, bams = tumor_normal_bams
    recs = {}
    for dev in ("cpu", "cuda"):
        out = run_somatic(fa, bams["normal"], bams["tumor"],
                          str(d / f"som_{dev}.vcf.gz"), device=dev)
        recs[dev] = read_vcf(out)[1]
    assert sum(r.filter == "PASS" for r in recs["cuda"]) >= 10
    assert records_mismatch(recs["cpu"], recs["cuda"]) is None
    with open(d / "som_cpu.ped") as a, open(d / "som_cuda.ped") as b:
        assert a.read() == b.read()


def _var_case_bam(d, device):
    """A random 20 kbp genome whose diploid sample carries SNVs, 1-8 bp
    indels and SNV pairs 1-2 bp apart (the groups the haplotype scan
    scores, as tests/test_torch_var.py plants them), 25x of 100 bp pairs
    aligned by the port on ``device``; returns (fasta, bam)."""
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.formats.fasta import decode_bases
    from speedseq_tpu_torch.utils import sim

    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 20_000).astype(np.uint8)
    fa = str(d / "v.fa")
    s = decode_bases(g).decode()
    with open(fa, "w") as fh:
        fh.write(">chrV\n" + "\n".join(s[i:i + 60]
                                       for i in range(0, len(s), 60)) + "\n")
    hap, variants, coord = sim.mutate(g, rng, snv_rate=0.003,
                                      indel_rate=0.001)
    taken = np.array([p for p, _, _ in variants])
    for i, pos in enumerate(range(400, 19600, 800)):
        h = np.searchsorted(coord, pos)
        gap = 1 + i % 2
        if np.abs(taken - pos).min() > 12 and coord[h + gap] == pos + gap:
            for k in (h, h + gap):
                hap[k] = (hap[k] + 1) % 4
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(
        g, 2500, read_len=100, seed=11, diploid_genome=hap, coord_map=coord)
    sim.to_fastq(str(d / "v1.fq"), str(d / "v2.fq"), names, s1, q1, s2, q2)
    align_fastq(fa, str(d / "v1.fq"), str(d / "v2.fq"),
                out_prefix=str(d / "v"),
                config=AlignConfig(batch_size=512, rg_string=(
                    "@RG\\tID:v\\tSM:v")), device=device)
    return fa, str(d / "v.bam")


def test_var_on_cuda_launches_the_unbanded_kernel(tmp_path):
    """run_var on cuda runs the haplotype scan through
    ssq_sw_unbanded_score (one launch a scan call), with the records of
    the CPU run."""
    _need_card()
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.metrics import metrics
    from speedseq_tpu_torch.utils.somatic_cases import records_mismatch
    from speedseq_tpu_torch.var.engine import run_var

    fa, bam = _var_case_bam(tmp_path, "cuda")
    recs = {}
    for dev in ("cpu", "cuda"):
        metrics.reset()
        sw_unbanded.reset_launches()
        out = str(tmp_path / f"var_{dev}.vcf.gz")
        run_var(fa, [bam], out, device=dev)
        recs[dev] = read_vcf(out)[1]
        calls = metrics.snapshot().get(f"var.hap_scan_calls.{dev}", 0)
        launches = sw_unbanded.LAUNCHES["sw_unbanded_score"]
        assert launches == (calls if dev == "cuda" else 0)
    assert launches > 0
    assert len(recs["cuda"]) > 0
    assert records_mismatch(recs["cpu"], recs["cuda"]) is None


def test_realign_cuda_matches_cpu(tumor_normal_bams):
    """realign of the normal BAM on cuda against cpu: the BAM triples
    record-equal, headers equal."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import AlignConfig
    from speedseq_tpu_torch.align.realign import realign
    from speedseq_tpu_torch.formats.bam import read_bam

    d, fa, bams = tumor_normal_bams
    outs = {dev: realign(fa, [bams["normal"]], str(d / f"re_{dev}"),
                         config=AlignConfig(batch_size=500), device=dev)
            for dev in ("cpu", "cuda")}
    for k in ("bam", "splitters.bam", "discordants.bam"):
        hc, rc = read_bam(outs["cpu"][k])
        hg, rg = read_bam(outs["cuda"][k])
        assert hc.text == hg.text
        assert len(rc) == len(rg) and all(a == b for a, b in zip(rc, rg)), k
        assert os.path.exists(outs["cuda"][k] + ".bai")
    assert len(read_bam(outs["cuda"]["bam"])[1]) >= 3000


@pytest.fixture(scope="module")
def fm_case(tmp_path_factory):
    """A random 60 kbp genome's FMD index (dense and walk, on the card)
    and 600 reads of 151 bp: every 5th cut short, some with Ns, some
    random, some seed-killed."""
    _need_card()
    from speedseq_tpu_torch.index.bwt import build_index
    from speedseq_tpu_torch.index.fm import FMIndex
    from speedseq_tpu_torch.utils import synth

    d = tmp_path_factory.mktemp("gfm")
    g = synth.make_genome(seed=21, n_del=4)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    idx = build_index(fa)
    rd = synth.simulate(g, 600, read_len=151, seed=22, kill_frac=0.1)
    rng = np.random.default_rng(23)
    reads = rd.seq2.copy()
    lens = np.full(600, 151, np.int32)
    lens[::5] = rng.integers(20, 151, len(lens[::5]))
    for i in range(0, 600, 5):
        reads[i, lens[i]:] = 4
    reads[1::13, rng.integers(0, 151)] = 4
    reads[2::17] = rng.integers(0, 4, (len(reads[2::17]), 151))
    fms = {dense: FMIndex.from_bwa_fm(idx, device="cuda",
                                      dense_sa_max=1 << 25 if dense else 0)
           for dense in (True, False)}
    return fa, reads, lens, fms


@pytest.mark.parametrize("stride", [8, 5])
def test_fm_smem_kernel_matches_twin(fm_case, stride):
    _need_card()
    from speedseq_tpu_torch.align.seeding import grid
    from speedseq_tpu_torch.ops import fm_search

    _, reads, lens, fms = fm_case
    r, l = torch.from_numpy(reads).cuda(), torch.from_numpy(lens).cuda()
    starts = grid(reads.shape[1], stride, "cuda")
    before = fm_search.LAUNCHES["fm_smem"]
    got = fm_search.fm_smem(fms[True], r, l, starts)
    torch.cuda.synchronize()
    assert fm_search.LAUNCHES["fm_smem"] == before + 1
    want = fm_search.fm_smem_plain(fms[True], r, l, starts)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert int(got.alive0.sum()) > 0


@pytest.fixture(scope="module")
def fm_edge(tmp_path_factory):
    """``utils/fm_cases.py``'s genomes' FMD indexes, on the card: the two
    edge-case genomes and the last-rank genome (primary == seq_len)."""
    _need_card()
    from speedseq_tpu_torch.index.bwt import build_index
    from speedseq_tpu_torch.index.fm import FMIndex
    from speedseq_tpu_torch.utils import fm_cases, synth

    d = tmp_path_factory.mktemp("gfmedge")
    out = {}
    genomes = {**fm_cases.edge_genomes(seed=31),
               "last-rank": fm_cases.last_rank_genome(seed=41)}
    for name, g in genomes.items():
        fa = str(d / f"{name}.fa")
        synth.write_fasta(fa, g)
        out[name] = (g, FMIndex.from_bwa_fm(build_index(fa), device="cuda"))
    return out


@pytest.mark.parametrize("L", [101, 151, 251])
@pytest.mark.parametrize("genome", ["random", "tandem"])
def test_fm_smem_edge_cases_kernel_matches_twin(fm_edge, genome, L):
    """The kernel bit-equal to its twin at every anchor of the edge-case
    reads (the inputs of tests/test_torch_fm.py::test_fm_smem_edge_cases,
    which reach each branch of the kernel's extension step)."""
    _need_card()
    from speedseq_tpu_torch.align.seeding import grid
    from speedseq_tpu_torch.ops import fm_search
    from speedseq_tpu_torch.utils import fm_cases

    g, fm = fm_edge[genome]
    reads, lens = fm_cases.edge_reads(g, L, 20, seed=L)
    r, l = torch.from_numpy(reads).cuda(), torch.from_numpy(lens).cuda()
    starts = grid(L, 1, "cuda")
    before = fm_search.LAUNCHES["fm_smem"]
    got = fm_search.fm_smem(fm, r, l, starts)
    torch.cuda.synchronize()
    assert fm_search.LAUNCHES["fm_smem"] == before + 1
    want = fm_search.fm_smem_plain(fm, r, l, starts)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert int(got.alive0.sum()) > 0


def test_fm_sa_walk_kernel_matches_twin_and_dense(fm_case):
    """Every rank of the index (the sentinel row included) through the
    walk kernel against its twin and the full SA."""
    _need_card()
    from speedseq_tpu_torch.ops import fm_search

    _, _, _, fms = fm_case
    walk = fms[False]
    ranks = torch.arange(1, walk.seq_len + 1, dtype=torch.int32,
                         device="cuda")
    before = fm_search.LAUNCHES["fm_sa_walk"]
    got = fm_search.fm_sa_walk(walk, ranks)
    torch.cuda.synchronize()
    assert fm_search.LAUNCHES["fm_sa_walk"] == before + 1
    assert torch.equal(got, fm_search.fm_sa_walk_plain(walk, ranks))
    assert torch.equal(got, fms[True].sa_dense[1:])


@pytest.mark.parametrize("genome", ["random", "tandem", "last-rank"])
def test_fm_sa_walk_edge_genomes_every_rank(fm_edge, genome):
    """The walk kernel at every rank of ``utils/fm_cases.py``'s genomes
    (the edge genomes' last occ block partial, with an upper half; the
    last-rank genome's whole, with the sentinel rank seq_len past its
    last stored row) against its twin and the full SA; the index keeps its
    full SA, so its walk records are built here (without them the wrapper
    refuses the index)."""
    _need_card()
    from speedseq_tpu_torch.index.fm import walk_records
    from speedseq_tpu_torch.ops import fm_search

    _, fm = fm_edge[genome]
    walk = fm._replace(walk_rec=walk_records(fm))
    ranks = torch.arange(1, fm.seq_len + 1, dtype=torch.int32, device="cuda")
    before = fm_search.LAUNCHES["fm_sa_walk"]
    got = fm_search.fm_sa_walk(walk, ranks)
    torch.cuda.synchronize()
    assert fm_search.LAUNCHES["fm_sa_walk"] == before + 1
    assert torch.equal(got, fm_search.fm_sa_walk_plain(walk, ranks))
    assert torch.equal(got, fm.sa_dense[1:])
    with pytest.raises(ValueError, match="walk records"):
        fm_search.fm_sa_walk(fm, ranks)


@pytest.mark.parametrize("dense", [True, False])
def test_fm_find_seeds_cuda_matches_cpu(fm_case, dense):
    _need_card()
    from speedseq_tpu_torch.align.chain import chain_seeds
    from speedseq_tpu_torch.align.seeding import find_seeds
    from speedseq_tpu_torch.index.fm import FMIndex

    _, reads, lens, fms = fm_case
    fm = fms[dense]
    fm_cpu = FMIndex(*(t.cpu() if isinstance(t, torch.Tensor) else t
                       for t in fm))
    got = find_seeds(fm, torch.from_numpy(reads).cuda(),
                     torch.from_numpy(lens).cuda())
    want = find_seeds(fm_cpu, torch.from_numpy(reads), torch.from_numpy(lens))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(got.valid.sum()) > 0
    for a, b in zip(chain_seeds(got, 151), chain_seeds(want, 151)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dense", [True, False], ids=["dense-sa", "sa-walk"])
def test_align_candidates_cuda_matches_cpu(fm_case, dense):
    """The unfused API on cuda against cpu: align_candidates (n_chains 4:
    one launch of ssq_sw_unbanded_cigar at 2,400 lanes x 151 x 255) field
    for field, then select_alignments' alignments (MD strings included)
    equal."""
    _need_card()
    from speedseq_tpu_torch.align import core
    from speedseq_tpu_torch.index.fm import FMIndex
    from speedseq_tpu_torch.ops import sw_unbanded

    _, reads, lens, fms = fm_case
    fm = fms[dense]
    fm_cpu = FMIndex(*(t.cpu() if isinstance(t, torch.Tensor) else t
                       for t in fm))
    before = sw_unbanded.LAUNCHES["sw_unbanded_cigar"]
    got = core.align_candidates(fm, torch.from_numpy(reads).cuda(),
                                torch.from_numpy(lens).cuda())
    torch.cuda.synchronize()
    assert sw_unbanded.LAUNCHES["sw_unbanded_cigar"] == before + 1
    want = core.align_candidates(fm_cpu, torch.from_numpy(reads),
                                 torch.from_numpy(lens))
    for f, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f
    assert int((want.score > 0).sum()) > 400
    a = core.select_alignments(got, reads, lens)
    b = core.select_alignments(want, reads, lens)
    assert [(tuple(p), s and tuple(s)) for p, s in a] == \
        [(tuple(p), s and tuple(s)) for p, s in b]
    assert sum(p.aligned for p, _ in a) > 400


def test_fm_align_cuda_matches_cpu(fm_case, tmp_path):
    """align_fastq(seed_mode="fm") on cuda against cpu: the BAM triples
    record-equal, headers equal; the FM kernel ran."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.formats.bam import read_bam
    from speedseq_tpu_torch.ops import fm_search
    from speedseq_tpu_torch.utils import synth

    fa = fm_case[0]
    g = synth.make_genome(seed=21, n_del=4)
    rd = synth.simulate(g, 1000, read_len=150, seed=24, kill_frac=0.02)
    f1, f2 = str(tmp_path / "1.fq"), str(tmp_path / "2.fq")
    synth.write_fastq_pair(f1, f2, rd)
    cfg = AlignConfig(batch_size=500, seed_mode="fm")
    before = fm_search.LAUNCHES["fm_smem"]
    outs = {dev: align_fastq(fa, f1, f2, out_prefix=str(tmp_path / dev),
                             config=cfg, device=dev)
            for dev in ("cpu", "cuda")}
    assert fm_search.LAUNCHES["fm_smem"] == before + 4
    for k in ("bam", "splitters.bam", "discordants.bam"):
        hc, rc = read_bam(outs["cpu"][k])
        hg, rg = read_bam(outs["cuda"][k])
        assert hc.text == hg.text
        assert len(rc) == len(rg) and all(a == b for a, b in zip(rc, rg)), k
    assert len(read_bam(outs["cuda"]["bam"])[1]) >= 2000


# ------------------------------------------------ sharded and multi-process

@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    from speedseq_tpu_torch.utils import synth

    d = tmp_path_factory.mktemp("gmesh")
    g = synth.make_genome(seed=41, n_del=6)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 2048, read_len=150, seed=43, kill_frac=0.02)
    synth.write_fastq_pair(str(d / "1.fq"), str(d / "2.fq"), rd)
    return d, fa, rd


def test_mesh_step_two_shards_on_one_card(mesh_world):
    """distributed_fused_step on [cuda:0] * 2 against one shard: packed
    outputs bit-equal, XA lanes as a set, n_aligned equal; both SW
    kernels launched from the shard threads."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import _load_fm
    from speedseq_tpu_torch.parallel.mesh import (distributed_fused_step,
                                                  make_mesh)

    _, fa, rd = mesh_world
    _, fm, kidx = _load_fm(fa, torch.device("cuda"))
    B = 1024
    pad = lambda s: np.pad(s[:B], ((0, 0), (0, 1)), constant_values=4)
    args = (pad(rd.seq1), np.full(B, 150, np.int32), pad(rd.seq2),
            np.full(B, 150, np.int32))
    before = dict(sw_banded.LAUNCHES)
    outs = [distributed_fused_step(make_mesh(devices=devs), fm, *args,
                                   kidx=kidx)
            for devs in (["cuda:0"], ["cuda:0"] * 2)]
    assert all(sw_banded.LAUNCHES[k] > before[k] for k in before)
    one, two = outs
    for k in (0, 1, 2, 3, 4):
        assert torch.equal(one[k], two[k]), k
    xa = lambda m: {(e,) + tuple(m[e, :, j].tolist())
                    for e in range(m.shape[0])
                    for j in torch.nonzero(m[e, 0] >= 0).flatten().tolist()}
    assert xa(one[5].cpu()) == xa(two[5].cpu())
    assert one[7] == two[7] > B


def test_two_process_align_on_one_card(mesh_world):
    """Two align workers sharing cuda:0 over FileExchange: the BAM triple
    of one process on cuda, record for record."""
    _need_card()
    import json
    import subprocess
    import sys

    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.formats.bam import read_bam

    d, fa, _ = mesh_world
    f1, f2 = str(d / "1.fq"), str(d / "2.fq")
    single = align_fastq(fa, f1, f2, out_prefix=str(d / "single"),
                         config=AlignConfig(batch_size=256, insert_override=(
                             320.0, 50.0, 520, 120)), device="cuda")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("SSQ_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "speedseq_tpu_torch.parallel.multihost",
         "align", fa, f1, f2, str(d / "multi"), "2", str(p), str(d / "ex"),
         "256", "320,50,520,120", "gpu2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for p in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
        assert "on cuda:0" in out
    multi = json.loads(res[0][0].strip().splitlines()[-1])
    for k in ("bam", "splitters.bam", "discordants.bam"):
        hs, rs = read_bam(single[k])
        hm, rm = read_bam(multi[k])
        assert hs.text == hm.text
        assert len(rs) == len(rm) and all(a == b for a, b in zip(rs, rm)), k


def _need_cards():
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("one CUDA device: the mesh over several cards needs two")


def test_mesh_over_every_card(mesh_world, tmp_path):
    """make_mesh() over every visible card against one card: the packed
    step, coordinate_reshard (against the CPU), sharded genotyping and
    align_stream's BAM triple, bit for bit."""
    _need_cards()
    from speedseq_tpu_torch.align.pipeline import (AlignConfig, _load_fm,
                                                   align_fastq)
    from speedseq_tpu_torch.formats.bam import read_bam
    from speedseq_tpu_torch.parallel import mesh as pmesh
    from speedseq_tpu_torch.utils.var_cases import random_sites
    from speedseq_tpu_torch.var import device as vdevice

    d, fa, rd = mesh_world
    mesh = pmesh.make_mesh()
    n = mesh.size
    assert [str(x) for x in mesh.devices] == [f"cuda:{i}" for i in range(n)]
    _, fm, kidx = _load_fm(fa, torch.device("cuda"))
    B = 256 * n
    pad = lambda s: np.pad(s[:B], ((0, 0), (0, 1)), constant_values=4)
    args = (pad(rd.seq1), np.full(B, 150, np.int32), pad(rd.seq2),
            np.full(B, 150, np.int32))
    one = pmesh.distributed_fused_step(pmesh.make_mesh(devices=["cuda:0"]),
                                       fm, *args, kidx=kidx)
    got = pmesh.distributed_fused_step(mesh, fm, *args, kidx=kidx)
    for k in (0, 1, 2, 3, 4):
        assert torch.equal(one[k], got[k]), k
    assert one[7] == got[7]

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 40, (n, 4096)).astype(np.int64)
    rows = rng.integers(0, 1 << 30, (n, 4096, 3)).astype(np.int64)
    bounds = np.sort(rng.integers(0, 1 << 40, n - 1)).astype(np.int64)
    want = pmesh.coordinate_reshard(pmesh.make_mesh(devices=["cpu"] * n),
                                    keys, rows, bounds, 1024)
    for a, b in zip(want, pmesh.coordinate_reshard(mesh, keys, rows, bounds,
                                                   1024)):
        assert torch.equal(a, b.cpu())

    sites = random_sites(7, 300, 140, 2, 2)
    g1 = vdevice.genotype_sites(*sites, 0.001, 2, device="cuda", pooled=True)
    gn = vdevice.genotype_sites(*sites, 0.001, 2, pooled=True, mesh=mesh)
    for x, y in zip(g1[:-1], gn[:-1]):
        assert np.array_equal(x, y)

    f1, f2 = str(d / "1.fq"), str(d / "2.fq")
    cfg = AlignConfig(batch_size=256 * n)
    outs = {name: align_fastq(fa, f1, f2, out_prefix=str(tmp_path / name),
                              config=cfg, device=dev)
            for name, dev in (("one", "cuda:0"), ("all", mesh))}
    for k in ("bam", "splitters.bam", "discordants.bam"):
        assert read_bam(outs["one"][k])[1] == read_bam(outs["all"][k])[1], k


def test_processes_one_per_card(mesh_world):
    """One align worker per card (cuda:{rank}), resharded over gloo: the
    BAM triple of one process."""
    _need_cards()
    import json
    import socket
    import subprocess
    import sys

    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.formats.bam import read_bam

    d, fa, _ = mesh_world
    P = torch.cuda.device_count()
    f1, f2 = str(d / "1.fq"), str(d / "2.fq")
    single = align_fastq(fa, f1, f2, out_prefix=str(d / "single_pc"),
                         config=AlignConfig(batch_size=128, insert_override=(
                             320.0, 50.0, 520, 120)), device="cuda")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               SSQ_COORDINATOR=f"localhost:{port}")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "speedseq_tpu_torch.parallel.multihost",
         "align", fa, f1, f2, str(d / "per_card"), str(P), str(p),
         str(d / "ex_pc"), "128", "320,50,520,120", "pc", "reshard"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(P)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, res)):
        assert p.returncode == 0, err[-3000:]
        assert f"CollectiveExchange on cuda:{rank}" in out
    multi = json.loads(res[0][0].strip().splitlines()[-1])
    for k in ("bam", "splitters.bam", "discordants.bam"):
        hs, rs = read_bam(single[k])
        hm, rm = read_bam(multi[k])
        assert hs.text == hm.text and rs == rm, k


# ------------------------------------------------- the device step's spans

STAGES = ("seed_chain", "select", "extend", "rescue_xa", "pack")


@pytest.fixture(scope="module")
def stage_world(tmp_path_factory):
    from speedseq_tpu_torch.utils import synth

    d = tmp_path_factory.mktemp("gstage")
    g = synth.make_genome((200_000, 150_000, 100_000), seed=51, n_del=6)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g)
    rd = synth.simulate(g, 65_536, read_len=150, seed=53, kill_frac=0.01)
    synth.write_fastq_pair(str(d / "1.fq"), str(d / "2.fq"), rd)
    return d, fa, rd


def test_stage_stream_spans_tile_the_step(stage_world):
    """A 65,536-pair align on cuda: the five stages' stream spans
    (``align.stage.<s>.stream_s``) sum to the step's stream span
    (``align.device_step_s``) within 3 %, each stage read."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import align_fastq
    from speedseq_tpu_torch.utils.metrics import metrics

    d, fa, _ = stage_world
    metrics.reset()
    align_fastq(fa, str(d / "1.fq"), str(d / "2.fq"),
                out_prefix=str(d / "o"), device="cuda")
    snap = metrics.snapshot()
    step = snap["align.device_step_s"]
    stages = [snap[f"align.stage.{s}.stream_s"] for s in STAGES]
    assert all(v > 0 for v in stages), stages
    assert abs(sum(stages) - step) <= 0.03 * step, (sum(stages), step)


def test_every_launch_of_a_step_lies_in_one_stage_span(stage_world):
    """One traced step of 512 pairs under stage marks: every kernel
    launch, copy and set the host sends lies inside exactly one
    ``ssq.align.stage.<s>`` span, each stage records its marks, and no
    ``ssq.`` span reaches the device's timeline."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speedseq_tpu_torch.align import core
    from speedseq_tpu_torch.align.pipeline import _load_fm

    _, fa, rd = stage_world
    dev = torch.device("cuda")
    _, fm, kidx = _load_fm(fa, dev)
    B = 512
    pad = lambda s: torch.from_numpy(np.pad(
        s[:B], ((0, 0), (0, 1)), constant_values=4)).to(dev)
    ln = torch.full((B,), 150, dtype=torch.int32, device=dev)
    args = (pad(rd.seq1), ln, pad(rd.seq2), ln)
    take = lambda: torch.cuda.Event(enable_timing=True)
    core.fused_align_leaves(fm, *args, kidx=kidx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with core.stage_marks(take) as marks:
            core.fused_align_leaves(fm, *args, kidx=kidx)
        torch.cuda.synchronize()
    assert set(marks.seconds()) == set(STAGES)
    spans, calls = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        iv = (a, a + e.duration_ns(), name)
        if name.startswith("ssq."):
            assert e.device_type() == DeviceType.CPU, name
            if name.startswith("ssq.align.stage."):
                spans.append(iv)
        elif e.device_type() == DeviceType.CPU and (
                "LaunchKernel" in name or name.startswith(
                    ("cudaMemcpy", "cudaMemset"))):
            calls.append(iv)
    assert {s[2] for s in spans} == {f"ssq.align.stage.{s}" for s in STAGES}
    assert len(calls) > 100
    for a, b, name in calls:
        inside = [s for s in spans if s[0] <= a and b <= s[1]]
        assert len(inside) == 1, (name, a, b)


# --------------------------------------------------- the seed_chain kernel

@pytest.fixture(scope="module")
def seed_world():
    """KmerIndex (on the CPU) of a random and of a repeat-rich 400 kbp
    genome at k 17, 19 and 24."""
    from speedseq_tpu_torch.index import kmer
    from speedseq_tpu_torch.utils import seed_chain_cases as cases

    out = {}
    for kind in ("random", "repeats"):
        g = cases.genome(kind, 400_000, seed=11)
        for k in (17, 19, 24):
            out[kind, k] = (g, kmer.build_kmer_index(g, k=k))
    return out


def _on_card(kidx):
    return kidx._replace(**{f: getattr(kidx, f).cuda() for f in
                            ("bucket_start", "positions", "fp")})


def _assert_chains_equal(got, want):
    (gc, gp, gr), (wc, wp, wr) = got, want
    for name in gc._fields:
        a, b = getattr(gc, name), getattr(wc, name)
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), name
    assert torch.equal(gp.cpu(), wp.cpu()) and torch.equal(gr.cpu(), wr.cpu())


@pytest.mark.parametrize("kind,k,stride,H,K,B,L", [
    ("random", 19, 8, 4, 4, 2048, 151), ("repeats", 19, 8, 4, 4, 2048, 151),
    ("repeats", 17, 8, 4, 2, 1, 151), ("random", 24, 8, 4, 8, 333, 151),
    ("repeats", 24, 8, 8, 8, 257, 151), ("repeats", 17, 1, 4, 4, 64, 151),
    ("random", 19, 1, 4, 8, 33, 151), ("repeats", 24, 1, 2, 2, 7, 151),
    ("repeats", 19, 5, 1, 4, 99, 101), ("random", 19, 8, 4, 4, 5, 19),
    ("repeats", 19, 8, 4, 4, 511, 251)],
    ids=["random-2048", "repeats-2048", "k17-B1", "k24-K8-odd",
         "k24-H8", "k17-stride1", "stride1-K8", "k24-stride1-H2",
         "stride5-H1", "width-k", "width-251"])
def test_seed_chain_kernel_matches_twin(seed_world, kind, k, stride, H, K,
                                        B, L):
    """Both ends in one launch, bit-equal to the plain twin on the CPU in
    all eight Chains fields and pos / rend_pos: random and repeat-rich
    genomes (buckets past max_scan and max_occ), reads with N, shorter
    than the width and than k, all N; k 17 / 19 / 24, stride 1 (S up to
    1,080) to 8, max_hits 1 to 8, n_chains 2 / 4 / 8, B 1 to 2,048."""
    _need_card()
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils import seed_chain_cases as cases

    g, kidx = seed_world[kind, k]
    ends = [tuple(torch.from_numpy(a) for a in cases.reads(g, B, L,
                                                            seed=B + e))
            for e in (0, 1)]
    before = sc.LAUNCHES["seed_chain"]
    got = sc.seed_chain(_on_card(kidx), [(r.cuda(), ln.cuda())
                                         for r, ln in ends],
                        k=k, stride=stride, max_hits=H, n_chains=K)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["seed_chain"] == before + 1
    for (r, ln), res in zip(ends, got):
        want = sc.seed_chain_plain(kidx, r, ln, k, stride, H, K)
        _assert_chains_equal(res, want)
    assert any(res[0].valid.any() for res in got)


def test_seed_chain_kernel_mixed_ends(seed_world):
    """Ends of other widths and read types (uint8 and int32, so both go as
    int32), an end of one read, and one end alone: each equal to the
    twin."""
    _need_card()
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils import seed_chain_cases as cases

    g, kidx = seed_world["repeats", 19]
    ck = _on_card(kidx)
    r1, l1 = (torch.from_numpy(a) for a in cases.reads(g, 300, 151, seed=1))
    r2, l2 = (torch.from_numpy(a) for a in cases.reads(g, 1, 96, seed=2))
    for ends in ([(r1, l1), (r2.to(torch.int32), l2)], [(r2, l2), (r1, l1)],
                 [(r1.to(torch.int64), l1.to(torch.int64))]):
        got = sc.seed_chain(ck, [(r.cuda(), ln.cuda()) for r, ln in ends])
        for (r, ln), res in zip(ends, got):
            _assert_chains_equal(res, sc.seed_chain_plain(kidx, r, ln))


def test_seed_chain_makes_no_host_sync(seed_world):
    """The seed_chain stage of the step (both ends' ScoredChains) under
    torch's sync debug mode "error": a host sync would raise."""
    _need_card()
    from speedseq_tpu_torch.align import core
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils import seed_chain_cases as cases

    g, kidx = seed_world["random", 19]
    ck = _on_card(kidx)
    ends = [tuple(torch.from_numpy(a).cuda()
                  for a in cases.reads(g, 1024, 151, seed=e)) for e in (0, 1)]
    core.weight_candidates(None, ends, ck)   # builds the library
    torch.cuda.synchronize()
    before = sc.LAUNCHES["seed_chain"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = core.weight_candidates(None, ends, ck)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sc.LAUNCHES["seed_chain"] == before + 1
    assert len(got) == 2 and got[1].valid.shape == (1024, 4)


def test_seed_chain_kernel_refuses_what_it_cannot_take(seed_world):
    _need_card()
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils import seed_chain_cases as cases

    g, kidx = seed_world["random", 19]
    ck = _on_card(kidx)
    r, ln = (torch.from_numpy(a).cuda() for a in cases.reads(g, 4, 151))
    for kw in (dict(k=16), dict(k=25), dict(max_hits=9), dict(n_chains=0),
               dict(max_scan=33, max_hits=4)):
        with pytest.raises(ValueError):
            sc.seed_chain(ck, [(r, ln)], **kw)
    with pytest.raises(ValueError, match="read width"):
        sc.seed_chain(ck, [(r[:, :18], ln)])
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.full((1, 8000), 4, dtype=torch.uint8, device="cuda")
        sc.seed_chain(ck, [(wide, ln[:1])], stride=1, max_hits=8)
    with pytest.raises(ValueError, match="one device"):
        sc.seed_chain(ck, [(r, ln.cpu())])


def test_step_scored_chains_cuda_matches_cpu(mesh_world):
    """fused_align_step on 256 pairs: each end's ScoredChains equal on
    cuda and cpu; seed_chain launches once a step for both ends
    (``align.seed_chain.kernel_reads`` + 512)."""
    _need_card()
    from speedseq_tpu_torch.align import core
    from speedseq_tpu_torch.align.pipeline import _load_fm
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils.metrics import metrics

    _, fa, rd = mesh_world
    B = 256
    pad = lambda s: torch.from_numpy(np.pad(s[:B], ((0, 0), (0, 1)),
                                            constant_values=4))
    ln = torch.full((B,), 150, dtype=torch.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        _, fm, kidx = _load_fm(fa, torch.device(dev))
        args = [t.to(dev) for t in (pad(rd.seq1), ln, pad(rd.seq2), ln)]
        before = sc.LAUNCHES["seed_chain"]
        reads0 = metrics.snapshot().get("align.seed_chain.kernel_reads", 0)
        res[dev] = core.fused_align_step(fm, *args, kidx=kidx)
        torch.cuda.synchronize()
        n = metrics.snapshot().get("align.seed_chain.kernel_reads", 0)
        launches = sc.LAUNCHES["seed_chain"] - before
        if dev == "cuda":
            assert launches == 1
            assert n - reads0 == 2 * B
        else:
            assert launches == 0 and n == reads0
    for e in (0, 1):
        a, b = res["cpu"][e][3], res["cuda"][e][3]
        for name in a._fields:
            assert torch.equal(getattr(a, name),
                               getattr(b, name).cpu()), (e, name)


def test_hash_align_cuda_matches_cpu(mesh_world, tmp_path):
    """align_fastq on 2,048 pairs (batches of 512) on cuda against cpu: the
    BAM triples record-equal; every step launched seed_chain once and
    ``align.seed_chain.kernel_reads`` equals ``align.reads``."""
    _need_card()
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.formats.bam import read_bam
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils.metrics import metrics

    d, fa, _ = mesh_world
    cfg = AlignConfig(batch_size=512)
    outs = {}
    for dev in ("cpu", "cuda"):
        metrics.reset()
        before = sc.LAUNCHES["seed_chain"]
        outs[dev] = align_fastq(fa, str(d / "1.fq"), str(d / "2.fq"),
                                out_prefix=str(tmp_path / dev), config=cfg,
                                device=dev)
        snap = metrics.snapshot()
    assert sc.LAUNCHES["seed_chain"] == before + 4
    assert snap["align.seed_chain.kernel_reads"] == snap["align.reads"] == 4096
    for k in ("bam", "splitters.bam", "discordants.bam"):
        hc, rc = read_bam(outs["cpu"][k])
        hg, rg = read_bam(outs["cuda"][k])
        assert hc.text == hg.text
        assert len(rc) == len(rg) and all(a == b for a, b in zip(rc, rg)), k
