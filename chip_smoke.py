"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --against DIR [DIR ...] [--ablate DIR ...]

The second form runs only the device and build phases and against: the
fm_search.cu, sv_cluster.cu, sw_banded.cu, sw_unbanded.cu and
sv_combine.cu of earlier versions (each DIR holds any of them,
fm_search.cu and sv_cluster.cu with a389f54's C interface or this
checkout's, sw_banded.cu with c292ab1's or this checkout's, sw_unbanded.cu
with 61d0390's (its wide scan on tiles) or this checkout's, sv_combine.cu
with this checkout's; e.g. `git show c292ab1:speedseq_tpu_torch/ops/csrc/
sw_banded.cu > build/c292ab1/sw_banded.cu`) built beside this
checkout's, every kernel's output equal to its twin's (but those of the
--ablate sources: a kernel with a part cut out, timed to measure that
part's share), and each kernel of a source some DIR holds timed in turns
against this checkout's: fm_smem on both FM indexes; fm_sa_walk on the
12 M-rank index and on the 2^28 + 1-rank index at uniform ranks and at
the ranks find_seeds passes; the sweep at the sv phase's evidence and at
the genome and genome-piles shapes; sw_score at the main path's 768 x 151
x 256, at 768 x 150 x 256, 768 x 150 x 254 and 32,768 x 151 x 256,
sw_cigar at the main path's 16,384, 1,024 and 256 x 151 x 256, the same
lane counts x 150 x 256 and on the inputs one batch of the align cell
gives it; sw_unbanded_score on hap_scan_lanes, on 280 lanes of var's 150
x 192 and on 250 x 320 (the narrow entry, with each kernel's SASS hash
by library and the ptxas lines), sw_unbanded_score_wide on 1,000 and
2,000 bp reads (1000 x 1088, 2000 x 2112; this checkout's kernel also at
one warp and at 4 warps an alignment) and sw_unbanded_cigar on the
unfused phase's launch (32,768 x 150 x 254, captured from
align_candidates) and on cigar_lanes (with
its SASS loops); sv_combine_logsum on both sides of the SV_PILE pile and
of 2,000 rows of random evidence (and, where a DIR also holds an
sv_combine.py, that wrapper against this one); with the SASS loops of
both banded SW kernels (registers, shared bytes, and each row loop's
instructions, shuffles, loads and stores) and the device time alone and
per kernel of the versions without host syncs.  --ablate takes any of
the five sources (utils/cigar_ablations.py writes the traceback DP's).
Then the nvidia-smi line and the last line.

Phases, each printing one JSON line:

  device   the card (nvidia-smi name, power limit, max SM clock)
  build    nvcc build of the kernels from the checkout (one nvcc per source,
           all six started together), with ptxas reports
  kernels  each SW kernel against its plain PyTorch twin on the card at
           production shapes (bit-equal), with kernel (per wrapper call and
           the device's alone) / twin / bound times; sw_cigar also with its
           device time at the main path's three launches (16,384, 1,024
           and 256 x 151 x 256) and the device memory one call allocates
  parity   2,048 pairs through align_fastq on cpu and on cuda: the BAM
           triples must be record-equal
  kernels  (seed_chain) hash seeding and NMS chaining of both ends of the
           align cell's batch (512 pairs x 151) in one launch against the
           twin on the card (bit-equal): kernel / device / twin / bound ms
  kernels  (fm) the FM index of the align genome loaded with no SA cache
           (timed), then fm_smem against its twin (bit-equal) at 8,192
           reads x 19 anchors = 155,648 lanes and fm_sa_walk against its
           twin and the full SA at 622,592 ranks on an index without the
           full SA: kernel / twin / bound times, extension steps run; then
           both again beyond the L2, on the FMD index of a random 2^27-code
           half-text and its reverse complement (2^28 + 1 ranks, SA by
           prefix doubling on the card), fm_smem on 8,192 reads of 150 bp
           cut from the half-text at 0.2 % substitutions, and the walk at
           the ranks find_seeds passes it there (4 hits a lane, dead hits
           at rank 1)
  parity   (fm) the same 2,048 pairs with seed_mode="fm" on cpu and on
           cuda, record-equal, and once more on cuda with an index
           without the full SA (the SA-walk path), record-equal too
  align    65,536 pairs × 150 bp (synthetic 3-contig ~6 Mbp genome with 64
           planted deletions and a duplicated segment, 1% seed-killed read-2
           ends) through the port's CLI entry on cuda, with the reference's
           in-process cache cleared first, so the run loads the bwa index
           from disk and builds the k-mer index as a fresh CLI run does;
           reads/s with and without that load, device-step share, kernel
           launch counts (seed_chain once a step, every read through it),
           record counts, accuracy vs truth; then the
           same pairs through ``align --seed-mode fm`` (SMEM seeding),
           reported and held to the same bars
  kernels  (align batch) sw_cigar on the inputs one batch of the align
           cell gives each of its three launches (captured from
           align_fastq), against its twin (bit-equal), device time
  unfused  the unfused alignment API on cuda: read 1 of one align-cell
           batch (8,192 reads of 150 bp) through align_candidates
           (n_chains 4, the fm phase's FM index: one launch of
           sw_unbanded_cigar at 32,768 lanes x 150 x 254), then
           select_alignments and assemble_records on the host: walls,
           >= 95 % mapped and >= 95 % within 12 bp of truth, the first
           1,024 reads' candidates equal on cpu, and the kernel against
           its twin (bit-equal) at that launch: wrapper and device ms,
           the twin's ms, the bound
  realign  the align phase's BAM (65,536 pairs) through the port's CLI
           ``realign`` on cuda (batch 8,192, the reference's cache cleared
           first): wall, reads/s, extract / device-step / emit times, the
           peak of reads waiting for their mates, kernel launches; every
           primary read kept, >= 98 % of placements unchanged, read groups
           carried, the triple and its indexes written; then the parity
           phase's BAM realigned on cpu and on cuda: record-equal
  var      one 1 Mbp contig with a diploid sample (SNVs 0.3 %, indels
           0.05 %) at 30x (100,000 pairs × 150 bp) aligned by the port's
           CLI on cuda, then ``var`` through the CLI on cuda (ten 100 kb
           windows): wall, Mbp/s, reads/s, genotyping and haplotype-scan
           counters and times, recall/precision against the truth (>= 0.92
           each), sw_unbanded_score launched once a scan call, and runs
           over the first 200 kb (four windows) on cpu, on cuda and on
           cuda with 4 threads that must give the same records (the cuda
           run's largest scan call kept for the kernels phase); then var
           through the CLI on cuda and on cpu over a BAM of 1,000 bp reads
           (20x over 20 kb, SNV pairs on one haplotype): windows of Lr =
           1088, the wide scan kernel launched, records equal
  somatic  one 1 Mbp contig; germline heterozygous SNVs (0.1 %) in both
           samples, somatic heterozygous SNVs (0.02 %) in the tumor only;
           normal 100,000 pairs (30x) and tumor 200,000 pairs (60x) of
           150 bp aligned by the port's CLI on cuda, then ``somatic -t 1
           --gff`` through the CLI on cuda (a GTF of 20 two-exon coding
           transcripts): wall, Mbp/s, reads/s, var and annotate timers,
           device counters, PASS counts, recall (>= 0.6) and precision
           (>= 0.9) against the planted somatic SNVs, SSC, CSQ and PED
           checks, sw_unbanded_score launched once a scan call, and runs
           over the first 200 kb on cpu, on cuda and on cuda with 4
           threads that must give the same records
  sv       two contigs (1.5 + 0.5 Mbp) whose sample carries 8 deletions,
           4 tandem duplications and 4 inversions (all heterozygous) and a
           reciprocal translocation, 200,000 pairs × 150 bp (30x) aligned
           by the port's CLI on cuda, then ``sv -g -d -P -R`` through the
           CLI on cuda (the combination library's load and first two
           launches timed before it, apart): wall, Mbp/s, reads/s,
           per-stage timers, device
           counters, recall/precision against the planted events (>= 0.9
           each), genotypes and CN of the matched calls, sv_cluster and
           sv_combine_logsum (once a side) launched, and cpu/cuda parity
           of the records and readdepth calls over the same BAMs (the
           cuda run's combination inputs kept for the kernels phase)
  multi    sharded and multi-process runs on the card: the mesh step on
           one align-cell batch over [cuda:0] * 2 and over every visible
           card against fused_align_packed (bit-equal, XA as a set),
           coordinate_reshard on [cuda:0] * 2 against [cpu] * 2, sharded
           genotyping (the var phase's 200 kb) and SVTyper (the sv phase's
           calls) against unsharded, then two worker processes sharing
           cuda:0 over gloo for align (the first 32,768 pairs, merged and
           resharded), var and somatic (their first 200 kb) and sv (its
           BAM as two samples), each equal to one process; every wall,
           one process's and two's, beside the card's name and power limit
  kernels  then the sv_cluster sweep kernels against their twin (bit-equal)
           at the sv phase's evidence, at 1,048,576 rows in 16 groups and
           at 1,048,576 rows in 256 skewed groups with piles (genome-piles)
  combine  the cluster sweep + curve combination (``cluster_and_combine``)
           at one pile of SV_PILE members on cuda (sv_combine_logsum, one
           launch a side; its inputs kept for the kernels phase), timed,
           against cpu (the twin's member-rank loop, one step per member)
  kernels  sw_unbanded_score against its twin (bit-equal) on the var
           run's largest scan call, on hap_scan_lanes, on 250 bp reads
           (250 x 320) and, through the wide entry, on 1,000 and 2,000 bp
           reads (1000 x 1088, 2000 x 2112); sv_combine_logsum against
           its twin (bit-equal) on
           both sides of the sv run's cluster pass and of the pile, with
           index_add_ of the materialised log rows as the library
           yardstick, the wrapper's host time step by step, and the bound
           with the largest cluster's chain of adds (chain_ms)

Then the kernels line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check exits non-zero; with no
CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 rate (NVIDIA data sheet)
# int32 instructions a Hopper SM issues a clock: four schedulers, one warp
# instruction each (the INT pipe's 64 lanes and the FMA pipe's 64, which
# runs IMAD, together); work is counted in instructions, an operation fused
# with its neighbour (multiply-add, add-then-max, 3-input max) once
INT32_ISSUE_PER_SM = 128
POPC_PER_SM = 16                   # popcounts per SM per clock (sm_90)
MUFU_PER_SM = 16                   # MUFU (lg2, ex2, rcp) per SM per clock
FP32_PER_SM = 128                  # fp32 adds per SM per clock
FADD_LATENCY = 4                   # clocks from one dependent FADD to the next
GENOME = (2_500_000, 2_000_000, 1_500_000)   # contig lengths, 6 Mbp
PAIRS, BATCH = 65_536, 8_192       # align phase: batch = a 16,384-read step
PARITY_PAIRS, PARITY_BATCH = 2_048, 1_024
VAR_BP, VAR_PAIRS = 1_000_000, 100_000   # 30x of 2 × 150 bp
VAR_PARITY_BP = 200_000
SOM_BP = 1_000_000                 # somatic: one contig, normal 30x, tumor 60x
SOM_NORMAL_PAIRS, SOM_TUMOR_PAIRS = 100_000, 200_000
SOM_GENES = 20                     # two-exon coding transcripts in its GTF
SV_BP, SV_PAIRS = (1_500_000, 500_000), 200_000   # 30x of 2 × 150 bp
SV_SLACK = 150                     # breakpoint bar of tests/test_sv.py:126
SV_PILE = 4_096                    # members of the combine phase's cluster
FM_READS = 8_192                   # fm kernels: a batch's reads x 19 anchors
UNFUSED_READS = 8_192              # unfused: read 1 of one align-cell batch
UNFUSED_CHAINS = 4                 # align_candidates' n_chains (JAX default)
UNFUSED_PARITY = 1_024             # unfused: reads held cuda against cpu
VAR_LONG_BP = 20_000               # var: a contig for 1,000 bp reads at 20x
FM_BIG_HALF = 1 << 27              # beyond L2: FMD index of a random half-text


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def _spying(mod, name, keep):
    """Within the block every call of ``mod.<name>`` first hands its
    arguments to ``keep``; the real function then runs as before."""
    real = getattr(mod, name)

    def spy(*a, **k):
        keep(*a, **k)
        return real(*a, **k)

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, real)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """CUDA events around reps calls of fn after warmup, per call.  With
    queued, a ~20 ms spin kernel runs first, so that the host enqueues
    every call before the first starts: the device's time alone, not the
    host's (only for calls that make no host sync)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernels(args, clock_hz: float, n_sms: int):
    """Each kernel vs its twin at production shapes; returns per-kernel
    records (launches filled in after the align phase)."""
    import torch

    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.utils.sw_cases import sw_edge_cases

    records = {}
    for name, n in (("sw_cigar", 16384), ("sw_score", 768)):
        q, ql, r = sw_edge_cases(n, 151, 256, seed=args.seed)
        qd, qld, rd = (torch.from_numpy(a).cuda() for a in (q, ql, r))
        kern = getattr(sw_banded, name)
        plain = getattr(sw_banded, name + "_plain")
        before = sw_banded.LAUNCHES[name]
        got = [t.cpu() for t in kern(qd, qld, rd)]
        torch.cuda.synchronize()
        check(sw_banded.LAUNCHES[name] > before, f"{name} did not launch")
        want = [t.cpu() for t in plain(qd, qld, rd)]
        max_err = max(int((a.long() - b.long()).abs().max()) if a.numel()
                      else 0 for a, b in zip(got, want))
        check(max_err == 0, f"{name} disagrees with its twin ({max_err})")
        ms = cuda_ms(lambda: kern(qd, qld, rd), reps=20)
        device_ms = cuda_ms(lambda: kern(qd, qld, rd), reps=20, queued=True)
        plain_ms = cuda_ms(lambda: plain(qd, qld, rd), reps=3, warmup=1)
        bound = _sw_bound(name, q, ql, r, clock_hz, n_sms)
        extra = {}
        if name == "sw_cigar":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kern(qd, qld, rd)
            torch.cuda.synchronize()
            extra["max_memory_allocated_by_one_call"] = (
                torch.cuda.max_memory_allocated() - base)
            extra["device_ms_main_path"] = _cigar_main_path_ms(args.seed)
        records[name] = {
            "name": name, "route": "cuda",
            "source": "speedseq_tpu_torch/ops/csrc/sw_banded.cu",
            "replaces": ("speedseq_tpu/ops/sw_pallas.py:329" if name ==
                         "sw_cigar" else "speedseq_tpu/ops/sw_pallas.py:390"),
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None, **extra,
        }
        emit({"phase": "kernels", "kernel": name, "lanes": n, "Lq": 151,
              "Lr": 256, "bit_equal": True, "ms": ms, "device_ms": device_ms,
              "plain_ms": plain_ms, "int32_ops": bound["int32_ops"],
              "bytes": bound["bytes"], "bound_ms": bound["bound_ms"],
              **extra})
    return records


def _cigar_main_path_ms(seed):
    """sw_cigar's device time (queue filled first) at the main path's three
    launches, on edge cases of its shape: {lanes: ms} at 16,384
    (extend_candidates), 1,024 (_extend_xa) and 256 (the mate rescue's
    extension) x 151 x 256."""
    import torch

    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.utils.sw_cases import sw_edge_cases

    out = {}
    for n in (16384, 1024, 256):
        q, ql, r = (torch.from_numpy(a).cuda()
                    for a in sw_edge_cases(n, 151, 256, seed=seed + n))
        out[n] = cuda_ms(lambda: sw_banded.sw_cigar(q, ql, r), reps=20,
                         queued=True)
    return out


def phase_cigar_batch(work, fasta, genome, args):
    """sw_cigar on one align-cell batch's own inputs (each of its three
    launches, captured), against its twin (bit-equal), device time."""
    import torch

    from speedseq_tpu_torch.ops import sw_banded

    rec = {"phase": "kernels", "kernel": "sw_cigar",
           "case": "align cell batch", "launches": {}}
    for n, (q, ql, r, params, max_ops) in sorted(
            _capture_cigar_inputs(work, fasta, genome, args).items()):
        got = sw_banded.sw_cigar(q, ql, r, params, max_ops)
        want = sw_banded.sw_cigar_plain(q, ql, r, params, max_ops)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"sw_cigar disagrees with its twin on the align cell's "
              f"{n}-lane batch")
        rec["launches"][n] = {
            "Lq": q.shape[1], "Lr": r.shape[1], "bit_equal": True,
            "device_ms": cuda_ms(lambda: sw_banded.sw_cigar(
                q, ql, r, params, max_ops), reps=20, queued=True)}
    emit(rec)


def _sw_bound(kernel, q, ql, r, clock_hz, n_sms):
    """The least time of a SW function on these (numpy) inputs: the rows
    it runs x 128 band cells x its instructions a cell
    (ops/sw_banded.py:OPS_PER_CELL_*), or its bytes (48 ops and lens a
    cigar lane)."""
    import numpy as np

    from speedseq_tpu_torch.ops import sw_banded

    n, Lq = q.shape
    rows = np.minimum(np.maximum(ql, 1), Lq).astype(np.int64)
    cigar = kernel == "sw_cigar"
    opc = (sw_banded.OPS_PER_CELL_CIGAR if cigar else
           sw_banded.OPS_PER_CELL_SCORE)
    n_out = (9 + 2 * 48) * n if cigar else 5 * n
    return _ops_bound(float(rows.sum()) * sw_banded.BAND * opc, 0,
                      4.0 * (q.size + ql.size + r.size + n_out), clock_hz,
                      n_sms)


def phase_fm_kernels(work, fasta, genome, args, clock_hz: float,
                     n_sms: int):
    """The FM index loaded with no SA cache (timed), then fm_smem against
    its twin (bit-equal) at the align cell's shape, 8,192 reads x 19
    anchors, and fm_sa_walk against its twin and the full SA at 4 ranks
    per lane, on an index built without the full SA; then both again on
    an index beyond the L2 (the FMD of a random half-text, 2^28 + 1
    ranks), fm_smem on 8,192 reads cut from that half-text; returns both
    kernels' records (launches filled in later)."""
    import torch

    fm_in = _fm_inputs(work, fasta, genome, args)
    fm, walk_fm, reads, lens, starts = (fm_in[k] for k in (
        "fm", "walk_fm", "reads", "lens", "starts"))
    records = {}
    got, small = _smem_case(fm, reads, lens, starts, clock_hz, n_sms)
    records["fm_smem"] = {
        "name": "fm_smem", "route": "cuda",
        "source": "speedseq_tpu_torch/ops/csrc/fm_search.cu",
        "replaces": "speedseq_tpu/align/seeding.py:109",
        "launches": 0, "max_abs_err": small["max_abs_err"],
        "ms": small["ms"], "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
        "library_ms": None}
    emit({"phase": "kernels", "kernel": "fm_smem",
          "index": "align genome, L2-resident", **small,
          "index_load_cold_s": fm_in["cold_load_s"], "seq_len": fm.seq_len})

    # the walk: 4 ranks per lane from the lanes' intervals (every lane,
    # not only the hits a seed keeps), on the index without the full SA;
    # its 4.5 MB of occ and BWT stay in L2
    ranks = _walk_ranks(got, fm)
    small = _walk_case(walk_fm, ranks, fm.sa_dense, clock_hz, n_sms)
    emit({"phase": "kernels", "kernel": "fm_sa_walk",
          "index": "align genome, L2-resident", "seq_len": fm.seq_len,
          **small})

    # beyond the L2 (a genome shard's index; the walk's own regime, above
    # 2^25 ranks): the FMD index of a random half-text, occ and BWT 4x
    # the L2; fm_smem on reads cut from the half-text, the walk at as
    # many uniform ranks as above
    big = _big_fm_inputs(args, ranks.numel())
    big_lanes, bigs = _smem_case(big["fm"], big["reads"], lens, starts,
                                 clock_hz, n_sms)
    emit({"phase": "kernels", "kernel": "fm_smem",
          "index": "random FMD text, beyond L2", "seq_len": big["fm"].seq_len,
          "index_build_s": big["build_s"], **bigs})
    bigw = _walk_case(big["fm"], big["ranks"], big["sa"], clock_hz, n_sms)
    emit({"phase": "kernels", "kernel": "fm_sa_walk",
          "index": "random FMD text, beyond L2", "seq_len": big["fm"].seq_len,
          "index_build_s": big["build_s"], **bigw})
    # the ranks find_seeds passes the walk on that index (the main path
    # of a genome above 2^25 ranks): 4 hits a lane, dead hits at rank 1
    path_ranks = _seed_ranks(big_lanes, starts)
    bigp = _walk_case(big["fm"], path_ranks, big["sa"], clock_hz, n_sms)
    emit({"phase": "kernels", "kernel": "fm_sa_walk",
          "index": "random FMD text, beyond L2",
          "ranks_from": "find_seeds (dead hits at rank 1)",
          "dead_hits": int((path_ranks == 1).sum()),
          "seq_len": big["fm"].seq_len, **bigp})
    del big
    torch.cuda.empty_cache()
    records["fm_sa_walk"] = {
        "name": "fm_sa_walk", "route": "cuda",
        "source": "speedseq_tpu_torch/ops/csrc/fm_search.cu",
        "replaces": "speedseq_tpu/index/fm.py:306",
        "launches": 0, "max_abs_err": bigw["max_abs_err"], "ms": bigw["ms"],
        "plain_ms": bigw["plain_ms"], "bound_ms": bigw["bound_ms"],
        "bound_by": bigw["bound_by"], "library_ms": None}
    return records


def _fm_inputs(work, fasta, genome, args):
    """The align genome's FM index loaded with no SA cache (timed), the
    same index without the full SA (the walk's), and the align cell's
    fm_smem batch: 8,192 reads of 150 bp in a width of 151, 19 anchors."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.align import pipeline
    from speedseq_tpu_torch.align.seeding import grid
    from speedseq_tpu_torch.index.fm import FMIndex
    from speedseq_tpu_torch.utils import synth

    cache = pipeline._sa_cache_path(fasta)
    if os.path.exists(cache):
        os.remove(cache)
    pipeline._host_cache.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, fm, _ = pipeline._load_fm(fasta, torch.device("cuda"), "fm")
    torch.cuda.synchronize()
    cold_load_s = time.perf_counter() - t0
    check(os.path.exists(cache), "the FM load wrote no SA cache")
    walk_fm = FMIndex.from_bwa_fm(idx, np.load(cache), "cuda",
                                  dense_sa_max=0)
    check(fm.sa_dense is not None and walk_fm.sa_dense is None,
          "dense / walk index split")
    rd = synth.simulate(genome, FM_READS, read_len=150, seed=args.seed + 500,
                        kill_frac=0.01)
    reads = np.full((FM_READS, 151), 4, np.uint8)
    reads[:, :150] = rd.seq1
    return {"fm": fm, "walk_fm": walk_fm, "reads": reads,
            "lens": np.full(FM_READS, 150, np.int32),
            "starts": grid(151, 8, "cuda"), "cold_load_s": cold_load_s}


def _walk_ranks(lanes, fm):
    import torch

    h = torch.arange(4, dtype=torch.int32, device="cuda")
    return (lanes.k[:, None] + h).clamp(1, fm.seq_len).reshape(-1)


def _seed_ranks(lanes, starts):
    """The ranks find_seeds hands the walk from these lanes (its own
    helper, defaults of bwa mem -k / -c), flattened."""
    from speedseq_tpu_torch.align.seeding import hit_ranks

    G = starts.shape[0]
    return hit_ranks(lanes, lanes.k.shape[0] // G, G)[0].reshape(-1)


def _big_fm_inputs(args, n_ranks):
    """The index beyond the L2 (FM_BIG_HALF codes and their reverse
    complement), 8,192 reads of 150 bp cut from the half-text at 0.2 %
    substitutions (numpy, from the seed) and n_ranks uniform ranks."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    fm, sa, half = _random_fm_index(FM_BIG_HALF, args.seed + 600)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 602)
    at = rng.integers(0, FM_BIG_HALF - 150, FM_READS)
    cut = torch.from_numpy(at[:, None] + np.arange(150)).cuda()
    body = half[cut].cpu().numpy()
    err = rng.random(body.shape) < 0.002
    body[err] = (body[err] + rng.integers(1, 4, int(err.sum()))) % 4
    reads = np.full((FM_READS, 151), 4, np.uint8)
    reads[:, :150] = body
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 601)
    ranks = torch.randint(1, fm.seq_len + 1, (n_ranks,), generator=gen,
                          device="cuda", dtype=torch.int32)
    return {"fm": fm, "sa": sa, "reads": reads, "ranks": ranks,
            "build_s": build_s}


def _smem_case(fm, reads, lens, starts, clock_hz, n_sms):
    """fm_smem on one batch against its twin (bit-equal), timed, with its
    bound from the steps the lanes took; returns (lanes, record)."""
    import torch

    from speedseq_tpu_torch.ops import fm_search

    B, L = reads.shape
    r_d, l_d = torch.from_numpy(reads).cuda(), torch.from_numpy(lens).cuda()
    G = starts.shape[0]
    n = B * G
    before = fm_search.LAUNCHES["fm_smem"]
    got = fm_search.fm_smem(fm, r_d, l_d, starts)
    torch.cuda.synchronize()
    check(fm_search.LAUNCHES["fm_smem"] > before, "fm_smem did not launch")
    want = fm_search.fm_smem_plain(fm, r_d, l_d, starts)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    check(err == 0, f"fm_smem disagrees with its twin ({err})")
    ms = cuda_ms(lambda: fm_search.fm_smem(fm, r_d, l_d, starts), reps=20)
    plain_ms = cuda_ms(lambda: fm_search.fm_smem_plain(fm, r_d, l_d, starts),
                       reps=2, warmup=0)
    steps, two = _smem_steps(got, reads, lens, starts.cpu().numpy())
    occ1, occ2 = fm_search.occ_ops(1), fm_search.occ_ops(2)
    total = float(steps.sum())
    one = total - two
    int_ops = (total * fm_search.OPS_PER_STEP
               + 2 * (one * occ1[0] + two * occ2[0]))
    popc_ops = 2 * (one * occ1[1] + two * occ2[1])
    # bytes: the reads, anchors and outputs, and of each index array no
    # more than the steps can read (a step: two checkpoint rows of 4 and
    # two blocks of 8 words)
    need = lambda t, words: 4.0 * min(t.numel(), words)
    index_bytes = (16 + need(fm.occ_ckpt, 8 * total)
                   + need(fm.bwt, 16 * total))
    nbytes = reads.size + 4.0 * (B + G) + index_bytes + 17.0 * n
    bound = _ops_bound(int_ops, popc_ops, nbytes, clock_hz, n_sms)
    alive = got.alive0.cpu().numpy()
    return got, {
        "reads": B, "anchors": G, "lanes": n, "alive_lanes": int(alive.sum()),
        "bit_equal": True, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "steps_total": int(total),
        "steps_two_class": int(two), "steps_longest_lane": int(steps.max()),
        **bound, "chain_ms": int(steps.max()) * fm_search.CHAIN_OPS_PER_STEP
        / clock_hz * 1e3}


def _smem_steps(got, reads, lens, p):
    """(extension steps each lane ran, steps whose base takes two
    popcount classes): each lane's successful extensions, plus the
    failing try when it reached the index (a base inside the read,
    within the loop's bound)."""
    import numpy as np

    from speedseq_tpu_torch.ops import fm_search

    B, L = reads.shape
    G = p.shape[0]
    qb, qe = (t.cpu().numpy().reshape(B, G).astype(np.int64)
              for t in (got.qbeg, got.qend))
    alive = got.alive0.cpu().numpy().reshape(B, G)
    p = p[None, :].astype(np.int64)
    rows = np.arange(B)[:, None]

    def base_at(q):
        inside = (q >= 0) & (q < lens[:, None])
        return np.where(inside, reads[rows, np.clip(q, 0, L - 1)], 4)

    fwd = (qe - p - 1) + ((qe - p < L) & (base_at(qe) < 4))
    bwd = (p - qb) + ((p - qb + 1 <= L) & (base_at(qb - 1) < 4))
    steps = np.where(alive, fwd + bwd, 0)
    # the base of every step (forward: read[p+1 .. p+fwd], backward:
    # read[p-bwd .. p-1]) sets the popcounts its lookups need; a forward
    # step extends by the complement, and POPCS_FOR_BASE is symmetric
    # under complement
    q = np.arange(L)[None, None, :]
    pq = p[..., None]
    on = alive[..., None] & (((q > pq) & (q <= pq + fwd[..., None]))
                             | ((q < pq) & (q >= pq - bwd[..., None])))
    popcs = np.asarray(fm_search.POPCS_FOR_BASE + (0,))[reads][:, None, :]
    two = int((on & (popcs == 2)).sum())
    check(int(on.sum()) == int(steps.sum()), "fm_smem step census")
    return steps, two


def _c_signature(path, fn):
    """The parameter list of ``fn``'s extern "C" declaration in a source,
    whitespace-normalised."""
    import re

    with open(path) as f:
        m = re.search(r'(?:extern "C" )?\bint ' + fn + r"\(([^)]*)\)",
                      f.read())
    return " ".join(m.group(1).split()) if m else None


def _earlier_libs(dirs):
    """{stem: [(name, lib, this_interface, ptxas lines)]}: the ctypes
    libraries of the fm_search.cu, sv_cluster.cu, sw_banded.cu,
    sw_unbanded.cu and sv_combine.cu each directory holds, named by the
    directory, each built with the C interface its source declares,
    function by function: this checkout's (its argument types are copied)
    or an earlier one (a389f54's walk on occ, BWT and mark arrays and
    sweep on gid segment starts; c292ab1's cigar kernel with its direction
    scratch ``dirs`` after max_ops; 61d0390's wide scan on tiles, C
    columns a thread and ntiles in the places of R and warps)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from speedseq_tpu_torch.ops import (fm_search, sv_cluster, sv_combine,
                                        sw_banded, sw_unbanded)
    from speedseq_tpu_torch.ops.nvcc_build import build_library

    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    earlier = {"ssq_fm_smem": [vp, vp, ci, ci, vp, ci, vp, vp, vp, ci, ci,
                               ci, vp, vp, vp, vp, vp, vp],
               "ssq_fm_sa_walk": [vp, ci, vp, vp, vp, ci, ci, ci, vp, vp,
                                  vp, ci, vp, vp],
               "ssq_sv_cluster": [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp],
               "ssq_sw_cigar": [vp] * 3 + [ci] * 8 + [vp, vp, cl, vp, vp,
                                                      vp],
               "ssq_sw_unbanded_score_wide": [vp] * 3 + [ci] * 9 + [
                   vp, cl, vp, vp]}
    MODS = {"fm_search": (fm_search, ("ssq_fm_smem", "ssq_fm_sa_walk")),
            "sv_cluster": (sv_cluster, ("ssq_sv_cluster",)),
            "sw_banded": (sw_banded, ("ssq_sw_cigar", "ssq_sw_score")),
            "sw_unbanded": (sw_unbanded, ("ssq_sw_unbanded_score",
                                          "ssq_sw_unbanded_score_wide",
                                          "ssq_sw_unbanded_cigar")),
            "sv_combine": (sv_combine, ("ssq_sv_combine_logsum",))}
    todo = []
    for d in dirs:
        for stem, (mod, fns) in MODS.items():
            path = os.path.abspath(os.path.join(d, stem + ".cu"))
            if not os.path.exists(path):
                continue
            here = os.path.join(os.path.dirname(mod.__file__), "csrc",
                                stem + ".cu")
            same = {f: _c_signature(path, f) == _c_signature(here, f)
                    for f in fns}
            check(all(same[f] or f in earlier for f in fns),
                  f"{path}: an unknown C interface")
            todo.append((d, stem, mod, fns, path, same, {}))
    # one nvcc a source, all started together
    with ThreadPoolExecutor(max(1, len(todo))) as pool:
        sos = list(pool.map(lambda x: build_library(x[4], x[6], True), todo))
    out = {stem: [] for stem in MODS}
    for (d, stem, mod, fns, path, same, info), so in zip(todo, sos):
        lib = ctypes.CDLL(so)
        for f in fns:
            getattr(lib, f).argtypes = (
                getattr(mod._load(), f).argtypes if same[f]
                else earlier[f])
        out[stem].append((os.path.basename(os.path.normpath(d)), lib,
                          all(same.values()), _ptxas_lines(info)))
    return out


def _sass_loops(so_path, pattern):
    """{function: [loop, ...]} of each kernel in a built library whose
    mangled name contains ``pattern``: every backward branch of its SASS
    (``cuobjdump -sass``) whose body holds a shuffle (a row loop), with
    its instructions counted by opcode, and a hash of its whole SASS."""
    import collections
    import hashlib
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", so_path], capture_output=True,
                         text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            if name:
                funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                      r"([^;]*);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(3),
                                m.group(4)))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, op, args in ins:
            tgt = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
                body = [o.split(".")[0] for a, o, _ in ins
                        if int(tgt.group(1), 16) <= a <= addr]
                if "SHFL" not in body:
                    continue
                loops.append({"start": hex(int(tgt.group(1), 16)),
                              "end": hex(addr), "instructions": len(body),
                              "ops": dict(collections.Counter(
                                  body).most_common())})
        sass = "\n".join(op + args for _, op, args in ins)
        out[fn] = {"instructions": len(ins), "loops": loops,
                   "sha1": hashlib.sha1(sass.encode()).hexdigest()[:16]}
    return out


def _sw_runs(libs, kernel, host, clock_hz, n_sms, params=(1, 4, 6, 1),
             max_ops=48):
    """(want, runs, bound) for one SW case: ``host`` (query, qlen, ref)
    numpy arrays or CUDA tensors through each library's ssq_sw_score /
    ssq_sw_cigar (c292ab1's cigar kernel, with its direction scratch, where
    the library declares that interface)."""
    import torch

    from speedseq_tpu_torch.ops import sw_banded

    host = [a.cpu().numpy() if torch.is_tensor(a) else a for a in host]
    bound = _sw_bound(kernel, *host, clock_hz, n_sms)
    q, ql, r = (torch.from_numpy(a).int().cuda() for a in host)
    n, Lq = q.shape
    Lr = r.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "sw_score":
        want = [t.int() for t in sw_banded.sw_score_plain(q, ql, r, params)]
        out = torch.empty((5, n), dtype=torch.int32, device="cuda")

        def run(lib):
            rc = lib.ssq_sw_score(q.data_ptr(), ql.data_ptr(), r.data_ptr(),
                                  n, Lq, Lr, *params, out.data_ptr(), n,
                                  stream)
            check(rc == 0, f"sw_score launch failed ({rc})")
            return list(out)
    else:
        w = sw_banded.sw_cigar_plain(q, ql, r, params, max_ops)
        want = [t.int() for t in w[:7] + w[9:] + w[7:9]]
        out = torch.empty((9, n), dtype=torch.int32, device="cuda")
        ops, lens = (torch.empty((n, max_ops), dtype=torch.int32,
                                 device="cuda") for _ in range(2))
        scratch = any(len(lib.ssq_sw_cigar.argtypes) == 17
                      for _, lib, _, _ in libs)
        dirs = (torch.empty((n, Lq, sw_banded.BAND), dtype=torch.int32,
                            device="cuda") if scratch else None)

        def run(lib):
            head = (q.data_ptr(), ql.data_ptr(), r.data_ptr(), n, Lq, Lr,
                    *params, max_ops)
            tail = (out.data_ptr(), n, ops.data_ptr(), lens.data_ptr(),
                    stream)
            if len(lib.ssq_sw_cigar.argtypes) == 17:   # c292ab1's
                rc = lib.ssq_sw_cigar(*head, dirs.data_ptr(), *tail)
            else:
                rc = lib.ssq_sw_cigar(*head, *tail)
            check(rc == 0, f"sw_cigar launch failed ({rc})")
            return list(out) + [ops, lens]
    return want, [(name, lambda l=lib: run(l))
                  for name, lib, _, _ in libs], bound


def _in_turns(kernel, case, runs, want, queued=(), unchecked=()):
    """Each run's output equal to ``want`` (but the runs named in
    ``unchecked``: ablations), then the runs timed in turns (the list,
    then the list reversed; CUDA events over 20 launches after 2 of
    warm-up), and the runs named in ``queued`` again with the queue filled
    first (their device time); emits and returns {name: [ms, ms]}."""
    import torch

    for name, run in runs:
        got = run()
        torch.cuda.synchronize()
        check(name in unchecked or all(
            torch.equal(a, b) for a, b in zip(got, want)),
            f"{kernel} of {name} disagrees with its twin ({case})")
    times = {name: [] for name, _ in runs}
    device = {name: [] for name, _ in runs if name in queued}
    for name, run in runs + runs[::-1]:
        times[name].append(cuda_ms(run, reps=20))
        if name in device:
            device[name].append(cuda_ms(run, reps=20, queued=True))
    emit({"phase": "against", "kernel": kernel, "case": case,
          "order": [n for n, _ in runs + runs[::-1]], "bit_equal": True,
          "ms": times, **({"device_ms": device} if device else {})})
    return times


def _kernel_split(fn, reps=5, pattern=r"sweep_\w+"):
    """Device microseconds per call of each kernel fn launches whose name
    matches ``pattern``, from torch.profiler (an empty dict where the
    profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    import re

    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        name = re.search(pattern, ev.key)
        if us and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + us / reps
    return out


def phase_against(work, fasta, genome, args, dirs, clock_hz, n_sms):
    """This checkout's kernels against earlier versions' (``--against DIR
    ...``: the fm_search.cu, sv_cluster.cu and sw_banded.cu each directory
    holds, built with the C interface each declares), in turns on this
    card, for each source some DIR holds: fm_smem on both FM indexes;
    fm_sa_walk on the 12 M-rank index, on the 2^28 + 1-rank index at
    uniform ranks and at the ranks find_seeds passes; the sweep at the sv
    phase's evidence and at the genome and genome-piles shapes, each as its
    wrapper runs it (a389f54's with its host syncs); the SW kernels at
    SW_AGAINST's shapes and sw_cigar on one align-cell batch's own inputs;
    with the device time and a per-kernel split of those that make no host
    sync, and the SASS loops of the SW kernels.  Every output equal to the
    twin's, but those of the ``--ablate DIR ...`` sources (sw_banded.cu
    with a part cut out, timed beside the others to measure that part's
    share).  The kernels are called through their libraries directly, so
    no wrapper counts those launches."""
    from speedseq_tpu_torch.ops import (fm_search, sv_cluster, sv_combine,
                                        sw_banded, sw_unbanded)

    earlier = _earlier_libs(dirs + (args.ablate or []))
    ablated = {os.path.basename(os.path.normpath(d))
               for d in args.ablate or []}
    if earlier["sw_banded"]:
        _against_sw(earlier["sw_banded"], clock_hz, n_sms,
                    _capture_cigar_inputs(work, fasta, genome, args),
                    ablated)
    if earlier["fm_search"]:
        _against_fm(work, fasta, genome, args, earlier["fm_search"])
    sv = (_sv_aligned(work, args)
          if earlier["sv_cluster"] or earlier["sv_combine"] else None)
    if earlier["sv_cluster"]:
        _against_sv(sv, args, earlier["sv_cluster"])
    if earlier["sw_unbanded"]:
        _against_unbanded(work, fasta, genome, args, earlier["sw_unbanded"],
                          clock_hz, n_sms, ablated)
    if earlier["sv_combine"]:
        _against_combine(sv, args, earlier["sv_combine"], ablated,
                         dirs + (args.ablate or []))
    emit({"phase": "against", "ptxas": {
        "earlier": {stem: {name: lines for name, _, _, lines in libs}
                    for stem, libs in earlier.items()},
        "this": {m.__name__.rsplit(".", 1)[1]: _ptxas_lines(m.BUILD_INFO)
                 for m in (fm_search, sv_cluster, sw_banded, sw_unbanded,
                           sv_combine)}}})


def _ptxas_lines(info):
    """The lines of a ptxas report that name a kernel, its registers and
    its spills."""
    return [l.strip() for l in info.get("ptxas", "").splitlines()
            if "registers" in l or "spill" in l or "Compiling" in l]


# The main path's SW launches are 151 wide (align/core.py pads the reads by
# one) against a 256-column window (_windows pads 254 to 256).  sw_score at
# the mate rescue's 768 lanes x 151 x 256, beside it a width of 150 (x 256)
# and a window that is no multiple of 4 (150 x 254); at 32,768 lanes (every
# chain of an 8,192-read batch end).  sw_cigar at the main path's three
# launches, each 151 x 256: extend_candidates (16,384 lanes), _extend_xa
# (1,024), the mate rescue's extension (256); beside them the same lane
# counts at a width of 150.
SW_AGAINST = (("sw_score", 768, 151, 256), ("sw_score", 768, 150, 256),
              ("sw_score", 768, 150, 254), ("sw_score", 32768, 151, 256),
              ("sw_cigar", 16384, 151, 256), ("sw_cigar", 1024, 151, 256),
              ("sw_cigar", 256, 151, 256), ("sw_cigar", 16384, 150, 256),
              ("sw_cigar", 1024, 150, 256), ("sw_cigar", 256, 150, 256))


def _capture_cigar_inputs(work, fasta, genome, args):
    """The sw_cigar inputs of one batch of the align cell: its first BATCH
    pairs through align_fastq on cuda with sw_banded.sw_cigar wrapped.
    {lanes: (query, qlen, ref, params, max_ops)}, the first call of each
    lane count (extend_candidates, _extend_xa, the mate rescue's
    extension), copied on the card."""
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.utils import synth

    f1, f2 = os.path.join(work, "a1.fq"), os.path.join(work, "a2.fq")
    if not os.path.exists(f1):
        synth.write_fastq_pair(f1, f2, synth.simulate(
            genome, PAIRS, read_len=150, seed=args.seed, kill_frac=0.01))
    b1, b2 = os.path.join(work, "b1.fq"), os.path.join(work, "b2.fq")
    for src, dst in ((f1, b1), (f2, b2)):
        with open(src) as fi, open(dst, "w") as fo:
            for _ in range(4 * BATCH):
                fo.write(fi.readline())
    got = {}
    kern = sw_banded.sw_cigar

    def capture(query, qlen, ref, params=(1, 4, 6, 1), max_ops=48):
        got.setdefault(query.shape[0], tuple(
            t.clone() for t in (query, qlen, ref)) + (tuple(params),
                                                       max_ops))
        return kern(query, qlen, ref, params, max_ops)

    sw_banded.sw_cigar = capture
    try:
        align_fastq(fasta, b1, b2, out_prefix=os.path.join(work, "capture"),
                    config=AlignConfig(batch_size=BATCH), device="cuda")
    finally:
        sw_banded.sw_cigar = kern
    check(len(got) == 3, f"sw_cigar lane counts of one batch: {list(got)}")
    return got


def _sw_row_loops(sass, ptxas):
    """For each SW kernel of one library: its registers and static shared
    bytes (ptxas) and, for each row loop (a SASS loop with shuffles), its
    instructions, shuffles and global and shared loads and stores."""
    import re

    out, name = {}, None
    for line in ptxas:
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        if name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {})["registers"] = int(regs.group(1))
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    for fn, info in sass.items():
        rec = out.setdefault(fn, {})
        rec["row_loops"] = [
            {"instructions": lp["instructions"],
             **{k: lp["ops"].get(k, 0) for k in (
                 "SHFL", "LDG", "STG", "LDS", "STS", "VOTE")}}
            for lp in info["loops"]]
        rec["sha1"] = info["sha1"]
    return out


def _against_sw(earlier, clock_hz, n_sms, captured, unchecked=()):
    """sw_score and sw_cigar of each library in turns at SW_AGAINST's
    shapes and sw_cigar on ``captured`` (one align-cell batch's inputs),
    with the device time, the profiler's kernel time and the bound, and
    the SASS loops of each library's SW kernels (registers, shared bytes,
    and each row loop's instructions, shuffles, loads and stores)."""
    import torch

    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.utils.sw_cases import sw_edge_cases

    libs = earlier + [("this", sw_banded._load(), True,
                       _ptxas_lines(sw_banded.BUILD_INFO))]
    sass = {name: _sass_loops(lib._name, "sw_") for name, lib, _, _ in libs}
    emit({"phase": "against", "kernel": "sw_banded", "sass": sass})
    emit({"phase": "against", "kernel": "sw_banded", "row_loops": {
        name: _sw_row_loops(sass[name], lines)
        for name, _, _, lines in libs},
        "sw_cigar_dynamic_smem_per_block": {
            Lq: sw_banded.cigar_smem_bytes(Lq) for Lq in (150, 151, 256)}})
    cases = [(k, f"{n} x {Lq} x {Lr}", sw_edge_cases(n, Lq, Lr, seed=n + Lr),
              (1, 4, 6, 1), 48) for k, n, Lq, Lr in SW_AGAINST]
    cases += [("sw_cigar", f"align cell batch, {n} x {c[0].shape[1]} x "
               f"{c[2].shape[1]}", c[:3], c[3], c[4])
              for n, c in sorted(captured.items(), reverse=True)]
    for kernel, label, host, params, max_ops in cases:
        want, runs, bound = _sw_runs(libs, kernel, host, clock_hz, n_sms,
                                     params, max_ops)
        _in_turns(kernel, label, runs, want, queued=[n for n, _ in runs],
                  unchecked=unchecked)
        emit({"phase": "against", "kernel": kernel, "case": label,
              "bound": bound, "profiler_us_per_call": {
                  name: _kernel_split(run, pattern=r"sw_\w+_kernel(<\w+>)?")
                  for name, run in runs}})
        del want, runs
        torch.cuda.empty_cache()


def _against_fm(work, fasta, genome, args, earlier):
    """fm_smem and fm_sa_walk of each library in turns (phase_against)."""
    import torch

    from speedseq_tpu_torch.ops import fm_search

    fm_libs = earlier + [("this", fm_search._load(), True, [])]
    fm_in = _fm_inputs(work, fasta, genome, args)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    lens_d = torch.from_numpy(fm_in["lens"]).cuda()
    st = fm_in["starts"]

    def smem(fm, reads):
        r8 = torch.from_numpy(reads).cuda()
        want = fm_search.fm_smem_plain(fm, r8, lens_d, st)

        def run(lib):
            out = [torch.empty_like(t) for t in want]
            rc = lib.ssq_fm_smem(
                r8.data_ptr(), lens_d.data_ptr(), *r8.shape, st.data_ptr(),
                st.numel(), *fm_search._index_args(fm),
                *(t.data_ptr() for t in out), stream())
            check(rc == 0, f"fm_smem launch failed ({rc})")
            return out
        return want, [(name, lambda l=lib: run(l))
                      for name, lib, _, _ in fm_libs]

    def walk(fm, ranks):
        want = [fm_search.fm_sa_walk_plain(fm, ranks)]
        out = torch.empty_like(want[0])

        def run(lib, this):
            index = (fm_search.walk_args(fm) if this else
                     fm_search._index_args(fm) + (
                         fm.sa_mark.data_ptr(), fm.sa_ckpt.data_ptr(),
                         fm.sa_vals.data_ptr(), fm.sa_vals.shape[0]))
            rc = lib.ssq_fm_sa_walk(ranks.data_ptr(), ranks.numel(), *index,
                                    out.data_ptr(), stream())
            check(rc == 0, f"fm_sa_walk launch failed ({rc})")
            return [out]
        return want, [(name, lambda l=lib, t=this: run(l, t))
                      for name, lib, this, _ in fm_libs]

    fm, walk_fm = fm_in["fm"], fm_in["walk_fm"]
    reads = fm_in["reads"]
    lanes = fm_search.fm_smem(fm, torch.from_numpy(reads).cuda(), lens_d, st)
    ranks = _walk_ranks(lanes, fm)
    big = _big_fm_inputs(args, ranks.numel())
    big_lanes = fm_search.fm_smem(big["fm"], torch.from_numpy(
        big["reads"]).cuda(), lens_d, st)
    cases = [("fm_smem", "align genome, L2-resident", smem(fm, reads)),
             ("fm_sa_walk", "align genome, L2-resident, lanes' ranks",
              walk(walk_fm, ranks)),
             ("fm_smem", "random FMD text, beyond L2",
              smem(big["fm"], big["reads"])),
             ("fm_sa_walk", "random FMD text, beyond L2, uniform ranks",
              walk(big["fm"], big["ranks"])),
             ("fm_sa_walk", "random FMD text, beyond L2, find_seeds ranks",
              walk(big["fm"], _seed_ranks(big_lanes, st)))]
    for kernel, case, (want, runs) in cases:
        _in_turns(kernel, case, runs, want)
    del big, big_lanes, cases
    torch.cuda.empty_cache()


def _against_sv(sv, args, earlier):
    """The sweep of each library in turns (phase_against), on the sv
    phase's evidence (``sv``: _sv_aligned's) and two synthetic shapes."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.ops import sv_cluster
    from speedseq_tpu_torch.utils import sv_cases

    sv_libs = earlier + [("this", sv_cluster._load(), True, [])]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def old_scan(lib, cols):     # a389f54's wrapper, its host syncs kept
        gid, s1, e1, lo2, hi2 = cols
        n = gid.shape[0]
        seg = sv_cluster.segments(gid)
        local = torch.empty(n, dtype=torch.int32, device="cuda")
        count = torch.empty(seg.shape[0], dtype=torch.int32, device="cuda")
        rc = lib.ssq_sv_cluster(
            seg.data_ptr(), seg.shape[0], n, s1.data_ptr(), e1.data_ptr(),
            lo2.data_ptr(), hi2.data_ptr(), local.data_ptr(),
            count.data_ptr(), stream())
        check(rc == 0, f"sv_cluster launch failed ({rc})")
        return [sv_cluster._globalise(local, count, seg, n)]

    def new_scan(lib, cols):     # this checkout's wrapper, on lib
        n = cols[0].shape[0]
        nb = (n + sv_cluster.TILE_ROWS - 1) // sv_cluster.TILE_ROWS
        tile_key = torch.empty(nb, dtype=torch.int64, device="cuda")
        tile_count = torch.empty(nb, dtype=torch.int32, device="cuda")
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        rc = lib.ssq_sv_cluster(
            cols[0].data_ptr(), n, *(c.data_ptr() for c in cols[1:]),
            tile_key.data_ptr(), tile_count.data_ptr(), out.data_ptr(),
            stream())
        check(rc == 0, f"sv_cluster launch failed ({rc})")
        return [out]

    for shape, cols in (("sv_phase", _sweep_cols(sv)),
                        ("genome", sv_cases.sweep_columns("genome",
                                                          seed=args.seed)),
                        ("genome-piles", sv_cases.sweep_columns(
                            "genome-piles", seed=args.seed))):
        dev = [torch.from_numpy(np.ascontiguousarray(c)).cuda()
               for c in cols]
        want = [sv_cluster.cluster_scan_plain(*(torch.from_numpy(c)
                                                for c in cols)).cuda()]
        runs = [(name, lambda d=dev, l=lib, t=this:
                 (new_scan if t else old_scan)(l, d))
                for name, lib, this, _ in sv_libs]
        synced = [name for name, _, this, _ in sv_libs if this]
        _in_turns("sv_cluster", f"{shape}, {len(cols[0])} rows", runs, want,
                  queued=synced)
        emit({"phase": "against", "kernel": "sv_cluster",
              "case": f"{shape}, {len(cols[0])} rows",
              "profiler_us_per_call": {
                  name: _kernel_split(run) for name, run in runs
                  if name in synced}})


def _against_unbanded(work, fasta, genome, args, earlier, clock_hz, n_sms,
                      unchecked=()):
    """The unbanded scan of each library in turns on hap_scan_lanes
    (150 x 192), on 280 lanes of var's shape (about one var call) and on
    250 bp reads (250 x 320), its wide entry on 1,000 and 2,000 bp reads
    (``_against_unbanded_wide``); the traceback DP (ssq_sw_unbanded_cigar) in
    turns on the unfused phase's launch (32,768 x 150 x 254, captured
    from align_candidates) and on cigar_lanes (150 x 254, cheap gaps);
    with the device time, and the SASS hash of each library's kernels
    (phase_against).  The outputs of the libraries named in ``unchecked``
    (--ablate) are not held to the twins."""
    import re

    import torch

    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import (cigar_lanes,
                                                    hap_scan_lanes,
                                                    unbanded_lanes)

    libs = earlier + [("this", sw_unbanded._load(), True,
                       _ptxas_lines(sw_unbanded.BUILD_INFO))]
    # each kernel's SASS hash by its name and template width, per library
    # (equal hashes: identical code)
    short = lambda fn: "".join(g or "" for g in re.search(
        r"\d(sw_unbanded_(?:wide_|cigar_|scan_)?kernel)(ILi\d+E)?",
        fn).groups())
    sass = {name: _sass_loops(lib._name, "sw_unbanded")
            for name, lib, _, _ in libs}
    emit({"phase": "against", "kernel": "sw_unbanded_score", "sass_sha1": {
        name: {short(fn): info["sha1"] for fn, info in funcs.items()}
        for name, funcs in sass.items()}, "ptxas": {
        name: lines for name, _, _, lines in libs}})
    # the traceback kernel's loops with shuffles (the row loop, the walk)
    emit({"phase": "against", "kernel": "sw_unbanded_cigar", "sass_loops": {
        name: [{"instructions": lp["instructions"], "ops": lp["ops"]}
               for fn, info in funcs.items() if "cigar" in fn
               for lp in info["loops"]]
        for name, funcs in sass.items()}})
    stream = torch.cuda.current_stream().cuda_stream
    for label, host in (
            ("hap_scan_lanes, 150 x 192", hap_scan_lanes(args.seed)),
            ("var call size, 150 x 192", unbanded_lanes(
                150, 192, seed=args.seed, n_edge=248)),
            ("250 bp reads, 250 x 320", unbanded_lanes(250, 320,
                                                       seed=args.seed))):
        q, ql, r = (torch.from_numpy(a).cuda() for a in host)
        n, Lq, Lr = q.shape[0], q.shape[1], r.shape[1]
        want = list(sw_unbanded.sw_score_unbanded_plain(q, ql, r))
        out = torch.empty((5, n), dtype=torch.int32, device="cuda")

        def run(lib):
            rc = lib.ssq_sw_unbanded_score(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), n, Lq, Lr, 1, 4,
                6, 1, out.data_ptr(), n, stream)
            check(rc == 0, f"sw_unbanded_score launch failed ({rc})")
            return list(out)

        _in_turns("sw_unbanded_score", f"{label}, {n} lanes",
                  [(name, lambda l=lib: run(l)) for name, lib, _, _ in libs],
                  want, queued=[name for name, _, _, _ in libs],
                  unchecked=unchecked)
    for label, Lq, Lr in (("1,000 bp reads, wide", 1000, 1088),
                          ("2,000 bp reads, wide", 2000, 2112)):
        _against_unbanded_wide(label, unbanded_lanes(Lq, Lr, seed=args.seed),
                               libs, unchecked)
    unfused = _capture_unfused_launch(fasta, genome, args)
    for label, host, params in (
            ("unfused launch", unfused, (1, 4, 6, 1)),
            ("cigar_lanes, 150 x 254, cheap gaps",
             cigar_lanes(150, 254, seed=args.seed), (1, 4, 1, 1))):
        q, ql, r = (torch.as_tensor(a).int().cuda() for a in host)
        n, Lq, Lr = q.shape[0], q.shape[1], r.shape[1]
        w = sw_unbanded.sw_cigar_unbanded_plain(q, ql, r, params)
        want = list(w[:5]) + [w[7], w[8], w[9], w[5], w[6]]
        out = torch.empty((8, n), dtype=torch.int32, device="cuda")
        ops = torch.empty((n, 48), dtype=torch.int8, device="cuda")
        lens = torch.empty((n, 48), dtype=torch.int32, device="cuda")

        def run_cigar(lib):
            rc = lib.ssq_sw_unbanded_cigar(
                q.data_ptr(), ql.data_ptr(), r.data_ptr(), n, Lq, Lr,
                *params, 48, out.data_ptr(), n, ops.data_ptr(),
                lens.data_ptr(), stream)
            check(rc == 0, f"sw_unbanded_cigar launch failed ({rc})")
            return list(out) + [ops, lens]

        runs = [(name, lambda l=lib: run_cigar(l)) for name, lib, _, _ in libs]
        _in_turns("sw_unbanded_cigar", f"{label}, {n} x {Lq} x {Lr}", runs,
                  want, queued=[name for name, _ in runs],
                  unchecked=unchecked)
        emit({"phase": "against", "kernel": "sw_unbanded_cigar",
              "case": f"{label}, {n} x {Lq} x {Lr}",
              "bound": _cigar_unbanded_bound(q, ql, r, clock_hz, n_sms),
              "profiler_us_per_call": {
                  name: _kernel_split(run, pattern=r"sw_unbanded_\w+")
                  for name, run in runs}})
        del want, w
        torch.cuda.empty_cache()


def _against_unbanded_wide(label, host, libs, unchecked=()):
    """The wide entry (ssq_sw_unbanded_score_wide) of each library in
    turns on one case (phase_against): 61d0390's interface with its
    layout (tiles of C = 20, 24 or 32 columns a thread, the row in shared
    memory up to 232,448 bytes), this checkout's with scan_layout's, and
    this checkout's kernel also at one warp an alignment (its stripes in
    turn through one buffer) and at up to 4 warps."""
    import torch

    from speedseq_tpu_torch.ops import sw_unbanded

    q, ql, r = (torch.from_numpy(a).cuda() for a in host)
    n, Lq, Lr = q.shape[0], q.shape[1], r.shape[1]
    want = list(sw_unbanded.sw_score_unbanded_plain(q, ql, r))
    out = torch.empty((5, n), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, a, b, scratch):
        rc = lib.ssq_sw_unbanded_score_wide(
            q.data_ptr(), ql.data_ptr(), r.data_ptr(), n, Lq, Lr, a, b, 1, 4,
            6, 1, out.data_ptr(), n,
            None if scratch is None else scratch.data_ptr(), stream)
        check(rc == 0, f"sw_unbanded_score_wide launch failed ({rc})")
        return list(out)

    def scratch_of(nbytes):     # n lanes of nbytes
        return torch.empty(n * nbytes, dtype=torch.uint8, device="cuda")

    runs, layouts = [], {}
    for name, lib, this, _ in libs:
        if this:
            mine = [(name, sw_unbanded.scan_layout(Lq))]
            if name == "this":
                mine += [("this, 1 warp", (8, 1)), ("this, 4 warps",
                         sw_unbanded.scan_layout(Lq, warps=4))]
            for label_, (R, W) in mine:
                fixed, buf = sw_unbanded.scan_smem_bytes(Lq, Lr, R, W)
                layouts[label_] = {"R": R, "warps": W}
                runs.append((label_, lambda l=lib, a=R, b=W, s=(
                    None if fixed + buf <= sw_unbanded.SMEM_MAX else
                    scratch_of(buf)): run(l, a, b, s)))
        else:
            ntiles = -(-Lr // 1024)
            C = next(c for c in (20, 24, 32) if 32 * c * ntiles >= Lr)
            ntiles = -(-Lr // (32 * C))
            layouts[name] = {"C": C, "ntiles": ntiles}
            row = ntiles * 32 * C * 12
            runs.append((name, lambda l=lib, a=C, b=ntiles, s=(
                None if row <= sw_unbanded.SMEM_MAX else scratch_of(row)):
                run(l, a, b, s)))
    emit({"phase": "against", "kernel": "sw_unbanded_score_wide",
          "case": f"{label}, {n} x {Lq} x {Lr}", "layouts": layouts})
    _in_turns("sw_unbanded_score_wide", f"{label}, {n} x {Lq} x {Lr}", runs,
              want, queued=[name for name, _ in runs], unchecked=unchecked)


def _unfused_reads(genome, args):
    """The unfused phase's input: read 1 of the align cell's first
    UNFUSED_READS pairs, (simulated pairs, reads (B, 150) int32, lengths)."""
    import numpy as np

    from speedseq_tpu_torch.utils import synth

    rd = synth.simulate(genome, PAIRS, read_len=150, seed=args.seed,
                        kill_frac=0.01)
    B = UNFUSED_READS
    return rd, rd.seq1[:B].astype(np.int32), np.full(B, 150, np.int32)


def _capture_unfused_launch(fasta, genome, args):
    """(query, qlen, ref) of the traceback DP's launch in align_candidates
    on the unfused phase's reads (the FM index built if missing)."""
    import torch

    from speedseq_tpu_torch.align import core, pipeline
    from speedseq_tpu_torch.ops import sw_unbanded

    _, reads_np, lens_np = _unfused_reads(genome, args)
    _, fm, _ = pipeline._load_fm(fasta, torch.device("cuda"), "fm")
    got = {}
    with _spying(sw_unbanded, "sw_cigar_unbanded", lambda q, ql, r, *a, **k:
                 got.setdefault("args", tuple(t.clone() for t in (q, ql, r)))):
        core.align_candidates(fm, torch.from_numpy(reads_np).cuda(),
                              torch.from_numpy(lens_np).cuda(),
                              n_chains=UNFUSED_CHAINS)
    return got["args"]


def _against_combine(sv, args, earlier, unchecked=(), dirs=()):
    """The member log-sum of each library in turns on both sides of the
    sv run's cluster pass (the sv phase's evidence, ``sv``: _sv_aligned's),
    of the SV_PILE pile and of 2,000 rows of random many-cluster evidence,
    with the device time and the profiler's kernel time; where a DIR also
    holds an sv_combine.py, that module's wrapper around its library in
    turns against this checkout's wrapper (phase_against).  The outputs
    of the libraries named in ``unchecked`` (--ablate) are not held to
    the twin."""
    import importlib.util

    import numpy as np
    import torch

    from speedseq_tpu_torch.ops import sv_combine
    from speedseq_tpu_torch.sv import device as sd
    from speedseq_tpu_torch.sv.cluster import evidence_columns
    from speedseq_tpu_torch.utils import sv_cases

    libs = earlier + [("this", sv_combine._load(), True,
                       _ptxas_lines(sv_combine.BUILD_INFO))]
    emit({"phase": "against", "kernel": "sv_combine_logsum", "ptxas": {
        name: lines for name, _, _, lines in libs}})
    wrappers = [("this", sv_combine.combine_logsum)]
    for d in dirs:
        path = os.path.join(d, "sv_combine.py")
        name = os.path.basename(os.path.normpath(d))
        lib = [l for n, l, _, _ in earlier if n == name]
        if os.path.exists(path) and lib:
            spec = importlib.util.spec_from_file_location(
                f"speedseq_tpu_torch.ops._sv_combine_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod._lib = lib[0]
            wrappers.insert(0, (name, mod.combine_logsum))
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(args.seed + 400)
    for label, ev in (("sv run", _sv_evidence(sv)),
                      ("pile", sv_cases.pile_evidence(rng, SV_PILE)),
                      ("random", sv_cases.random_evidence(rng, 2000))):
        calls = []
        with _spying(sv_combine, "combine_logsum",
                     lambda *a: calls.append(a)):
            sd.cluster_and_combine(*evidence_columns(ev)[1:], 0.0,
                                   device="cuda")
        for side, a in enumerate(calls):
            first, sizes, lo, start, clen, curves, W = (
                t.to(torch.int32).contiguous() if torch.is_tensor(t) and
                not t.is_floating_point() else t for t in a)
            want = [sv_combine.sv_combine_logsum_plain(*a)]
            acc = torch.empty_like(want[0])

            def run(lib):
                rc = lib.ssq_sv_combine_logsum(
                    first.data_ptr(), sizes.data_ptr(), lo.data_ptr(),
                    lo.shape[0], start.data_ptr(), clen.data_ptr(),
                    curves.data_ptr(), curves.shape[1], W, acc.data_ptr(),
                    stream)
                check(rc == 0, f"sv_combine_logsum launch failed ({rc})")
                return [acc]

            case = (f"{label}, side {side + 1}, {start.shape[0]} rows, "
                    f"{lo.shape[0]} clusters")
            runs = [(name, lambda l=lib: run(l)) for name, lib, _, _ in libs]
            _in_turns("sv_combine_logsum", case, runs, want,
                      queued=[name for name, _ in runs], unchecked=unchecked)
            emit({"phase": "against", "kernel": "sv_combine_logsum",
                  "case": case, "profiler_us_per_call": {
                      name: _kernel_split(r, pattern=r"combine_logsum_kernel")
                      for name, r in runs}})
            if len(wrappers) > 1:
                _in_turns("sv_combine_logsum wrapper", case,
                          [(name, lambda f=fn: [f(*a)])
                           for name, fn in wrappers], want)


def _ops_bound(int_ops, popc_ops, nbytes, clock_hz, n_sms):
    """The least time of a kernel's work: the larger of its int32
    operations over 128 lanes/SM/clock, its popcounts over 16/SM/clock and
    its bytes over the HBM rate."""
    ms = {"operations": max(int_ops / (n_sms * INT32_ISSUE_PER_SM),
                            popc_ops / (n_sms * POPC_PER_SM)) / clock_hz * 1e3,
          "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return {"int32_ops": int_ops, "popc_ops": popc_ops, "bytes": nbytes,
            "ops_ms": ms["operations"], "bytes_ms": ms["bytes"],
            "bound_ms": ms[by], "bound_by": by}


def _walk_case(walk_fm, ranks, sa_full, clock_hz, n_sms):
    """fm_sa_walk on ``ranks`` against its twin and the full SA (exact),
    timed, with its bound from the steps these ranks take."""
    import torch

    from speedseq_tpu_torch.ops import fm_search

    before = fm_search.LAUNCHES["fm_sa_walk"]
    walked = fm_search.fm_sa_walk(walk_fm, ranks)
    torch.cuda.synchronize()
    check(fm_search.LAUNCHES["fm_sa_walk"] > before,
          "fm_sa_walk did not launch")
    dense = sa_full[ranks.long()]
    err = max(int((walked.long() - t.long()).abs().max()) for t in
              (fm_search.fm_sa_walk_plain(walk_fm, ranks), dense))
    check(err == 0, f"fm_sa_walk disagrees with its twin or the SA ({err})")
    ms = cuda_ms(lambda: fm_search.fm_sa_walk(walk_fm, ranks), reps=20)
    plain_ms = cuda_ms(lambda: fm_search.fm_sa_walk_plain(walk_fm, ranks),
                       reps=2, warmup=0)
    wsteps = (dense % 32).long()     # one LF step a text position
    total, m = float(wsteps.sum()), ranks.numel()
    occ_int, occ_popc = fm_search.occ_ops(1)
    int_ops = (total * (fm_search.OPS_PER_WALK_STEP + occ_int)
               + m * fm_search.OPS_PER_WALK_RANK)
    popc_ops = total * occ_popc + m
    # bytes: the ranks and results, and of each index array no more than
    # the steps and ranks can read (a step: 4 occ ints, up to 8 BWT words
    # and a mark word; a rank: one more mark word, a checkpoint, a value)
    need = lambda t, reads: 4.0 * min(t.numel(), reads)
    nbytes = 8.0 * m + 16 + (need(walk_fm.occ_ckpt, 4 * total)
                             + need(walk_fm.bwt, 8 * total)
                             + need(walk_fm.sa_mark, total + m)
                             + need(walk_fm.sa_ckpt, m)
                             + need(walk_fm.sa_vals, m))
    return {"ranks": m, "equal_to_twin_and_sa": True, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "steps_total": int(total),
            "steps_longest": int(wsteps.max()),
            **_ops_bound(int_ops, popc_ops, nbytes, clock_hz, n_sms),
            "chain_ms": int(wsteps.max()) * fm_search.CHAIN_OPS_PER_STEP
            / clock_hz * 1e3}


def _random_fm_index(n_half: int, seed: int, device: str = "cuda"):
    """(FMIndex on the card without the full SA, full SA on the card, the
    half-text) of bwa's FMD layout over a random half-text of n_half
    codes: the text is the half-text and its reverse complement; the
    suffix array by prefix doubling on the card (argsort of 27-code keys,
    then of rank pairs), the BWT, occ checkpoints and C from it, and the
    SA samples by the port's own constructor (FMIndex.from_bwa_fm)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from speedseq_tpu_torch.index.bwt import OCC_INTERVAL
    from speedseq_tpu_torch.index.fm import FMIndex

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = torch.randint(0, 4, (n_half,), generator=gen, device=dev,
                         dtype=torch.uint8)
    text = torch.cat([half, 3 - half.flip(0)])
    n = text.numel()
    K = 27                               # 5^27 < 2^63: codes + 1, 0 past the end
    padded = torch.cat([text.long() + 1,
                        torch.zeros(K, dtype=torch.long, device=dev)])
    key = torch.zeros(n + 1, dtype=torch.long, device=dev)
    for j in range(K):
        key = key * 5 + padded[j:j + n + 1]
    del padded
    hop = K
    while True:
        sa = torch.argsort(key)
        sk = key[sa]
        fresh = torch.zeros(n + 1, dtype=torch.long, device=dev)
        fresh[1:] = (sk[1:] != sk[:-1]).cumsum(0)
        del sk
        if int(fresh[-1]) == n:
            break
        rank = torch.empty_like(fresh)
        rank[sa] = fresh
        nxt = torch.zeros_like(rank)
        nxt[:n + 1 - hop] = rank[hop:] + 1
        key = rank * (n + 2) + nxt
        del rank, nxt
        hop *= 2
    del key, fresh
    primary = int((sa == 0).nonzero()[0, 0])
    row = text.long()[(sa - 1).clamp_min(0)]
    stored = torch.cat([row[:primary], row[primary + 1:]])
    del row
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    padded = torch.full((n_blocks * OCC_INTERVAL,), 4, dtype=torch.long,
                        device=dev)                   # 4: past the end
    padded[:n] = stored
    per_block = torch.stack([(padded == c).reshape(n_blocks, -1).sum(1)
                             for c in range(4)], 1)
    occ = torch.zeros((n_blocks + 1, 4), dtype=torch.long, device=dev)
    occ[1:] = per_block.cumsum(0)
    sh = (15 - torch.arange(16, device=dev)) * 2
    words = ((padded & 3).reshape(-1, 16) << sh).sum(1)  # disjoint fields
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(torch.bincount(text.long(), minlength=4).cpu().numpy())
    idx = SimpleNamespace(pac=half.cpu().numpy(), L2=L2, primary=primary,
                          bwt_words=words.cpu().numpy().astype(np.uint32),
                          occ=occ.cpu().numpy())
    del padded, per_block, occ, words, stored
    fm = FMIndex.from_bwa_fm(idx, sa.cpu().numpy(), dev, dense_sa_max=0)
    return fm, sa.to(torch.int32), half


def read_records(path):
    from speedseq_tpu_torch.formats.bam import read_bam

    return read_bam(path)


def _same_triple(out_a, out_b, what):
    counts = {}
    for k in ("bam", "splitters.bam", "discordants.bam"):
        ha, ra = read_records(out_a[k])
        hb, rb = read_records(out_b[k])
        check(ha.text == hb.text, f"{what}: {k} headers differ")
        check(len(ra) == len(rb) and all(a == b for a, b in zip(ra, rb)),
              f"{what}: {k} records differ")
        counts[k] = len(rb)
    return counts


SEED_CHAIN_PAIRS = 512               # the align cell's batch: 1,024 reads


def phase_seed_chain(fasta, genome, args, clock_hz: float, n_sms: int):
    """The seed_chain kernel against its twin on the card (bit-equal) at
    the align cell's batch: both ends of 512 pairs x 151 in one launch, on
    the hash index of the smoke's genome.  Kernel (a wrapper call and the
    device alone), twin and bound ms."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.align.pipeline import _load_fm
    from speedseq_tpu_torch.index.kmer import find_seeds_hash
    from speedseq_tpu_torch.ops import seed_chain as sc
    from speedseq_tpu_torch.utils import synth

    _, _, kidx = _load_fm(fasta, torch.device("cuda"))
    rd = synth.simulate(genome, SEED_CHAIN_PAIRS, read_len=150,
                        seed=args.seed + 5, kill_frac=0.01)
    pad = lambda s: torch.from_numpy(np.pad(
        s, ((0, 0), (0, 1)), constant_values=4)).cuda()
    ln = torch.full((SEED_CHAIN_PAIRS,), 150, dtype=torch.int32,
                    device="cuda")
    ends = [(pad(rd.seq1), ln), (pad(rd.seq2), ln)]
    kern = lambda: sc.seed_chain(kidx, ends)
    plain = lambda: [sc.seed_chain_plain(kidx, r, n) for r, n in ends]
    before = sc.LAUNCHES["seed_chain"]
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(sc.LAUNCHES["seed_chain"] == before + 1, "seed_chain did not launch")
    for (gc, gp, gr), (wc, wp, wr) in zip(got, want):
        for a, b in zip(tuple(gc) + (gp, gr), tuple(wc) + (wp, wr)):
            check(torch.equal(a, b), "seed_chain disagrees with its twin")
    ms = cuda_ms(kern, reps=20)
    device_ms = cuda_ms(kern, reps=20, queued=True)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    # the bound: the first round's live same-strand pair tests (a lower
    # bound of all rounds') at OPS_PER_PAIR, or the bytes: reads, lengths
    # and outputs once, 8 of bucket_start an anchor that seeds, 8 of
    # position and fingerprint a live seed
    int_ops = nbytes = 0
    for r, n in ends:
        s = find_seeds_hash(kidx, r, n)
        live = s.valid.reshape(r.shape[0], 2, -1, 4)
        per_strand = live.flatten(2).sum(-1).long()
        int_ops += sc.OPS_PER_PAIR * int((per_strand ** 2).sum())
        nbytes += (r.numel() + 4 * n.numel() + 37 * 4 * r.shape[0]
                   + 8 * int(live.any(-1).sum()) + 8 * int(live.sum()))
    bound = _ops_bound(int_ops, 0, nbytes, clock_hz, n_sms)
    emit({"phase": "kernels", "kernel": "seed_chain",
          "reads": 2 * SEED_CHAIN_PAIRS, "width": 151, "bit_equal": True,
          "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, **bound})
    return {"name": "seed_chain", "route": "cuda",
            "source": "speedseq_tpu_torch/ops/csrc/seed_chain.cu",
            "replaces": "speedseq_tpu/index/kmer.py:find_seeds_hash + "
                        "speedseq_tpu/align/chain.py:chain_seeds_nms (jnp)",
            "launches": 0, "max_abs_err": 0, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None}


def phase_parity(work, fasta, genome, args, seed_mode="hash"):
    """2,048 pairs through align_fastq on cpu and on cuda: record-equal.
    With seed_mode "fm" a third run on cuda takes an index without the
    full SA (dense_sa_max=0: the path of a genome above 2^25 ranks), so
    every SA lookup is the fm_sa_walk kernel; the kernels' counts are set
    to 0 just before that run and returned."""
    import torch

    from speedseq_tpu_torch.align import pipeline
    from speedseq_tpu_torch.align.pipeline import AlignConfig, align_fastq
    from speedseq_tpu_torch.index.fm import FMIndex
    from speedseq_tpu_torch.ops import fm_search
    from speedseq_tpu_torch.utils import synth

    f1, f2 = os.path.join(work, "p1.fq"), os.path.join(work, "p2.fq")
    if not os.path.exists(f1):
        rd = synth.simulate(genome, PARITY_PAIRS, read_len=150,
                            seed=args.seed + 100, kill_frac=0.01)
        synth.write_fastq_pair(f1, f2, rd)
    cfg = AlignConfig(batch_size=PARITY_BATCH, seed_mode=seed_mode)
    tag = "" if seed_mode == "hash" else "_" + seed_mode
    t0 = time.perf_counter()
    out_c = align_fastq(fasta, f1, f2,
                        out_prefix=os.path.join(work, "pc" + tag),
                        config=cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_g = align_fastq(fasta, f1, f2,
                        out_prefix=os.path.join(work, "pg" + tag),
                        config=cfg, device="cuda")
    t_gpu = time.perf_counter() - t0
    counts = _same_triple(out_c, out_g, f"parity{tag}: cpu vs cuda")
    rec = {"phase": "parity", "seed_mode": seed_mode, "pairs": PARITY_PAIRS,
           "batch_size": PARITY_BATCH, "record_equal": True,
           "records": counts, "cpu_s": t_cpu, "cuda_s": t_gpu}
    launches = {}
    if seed_mode == "fm":
        load = pipeline._load_fm

        def load_walk(reference, device, mode="hash"):
            # the same index built without the full SA (dense_sa_max=0)
            idx, _, kidx = load(reference, device, mode)
            return idx, FMIndex.from_bwa_fm(
                idx, pipeline._full_sa(reference, idx), device,
                dense_sa_max=0), kidx

        pipeline._load_fm = load_walk
        try:
            torch.cuda.synchronize()
            fm_search.reset_launches()
            t0 = time.perf_counter()
            out_w = align_fastq(fasta, f1, f2,
                                out_prefix=os.path.join(work, "pw" + tag),
                                config=cfg, device="cuda")
            torch.cuda.synchronize()
            rec["cuda_walk_s"] = time.perf_counter() - t0
            launches = dict(fm_search.LAUNCHES)
        finally:
            pipeline._load_fm = load
        _same_triple(out_c, out_w, "parity_fm: cpu vs cuda (SA walk)")
        rec["walk_index_record_equal"] = True
        rec["walk_launches"] = launches
        check(launches["fm_sa_walk"] > 0 and launches["fm_smem"] > 0,
              f"the walk-index run did not launch both FM kernels "
              f"({launches})")
    emit(rec)
    return launches


def phase_align(work, fasta, genome, args, seed_mode="hash"):
    """The align cell through the CLI on cuda; ``seed_mode`` "fm" adds
    ``--seed-mode fm`` (SMEM seeding: fm_smem; the 6 Mbp genome keeps its
    full SA, so fm_sa_walk is off this path and its count is reported)."""
    import numpy as np
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.align import pipeline
    from speedseq_tpu_torch.formats.sam import (
        FSECONDARY, FSUPPLEMENTARY, FUNMAP, FREAD1)
    from speedseq_tpu_torch.ops import fm_search, seed_chain, sw_banded
    from speedseq_tpu_torch.utils import synth
    from speedseq_tpu_torch.utils.metrics import metrics

    rd = synth.simulate(genome, PAIRS, read_len=150, seed=args.seed,
                        kill_frac=0.01)
    f1, f2 = os.path.join(work, "a1.fq"), os.path.join(work, "a2.fq")
    if not os.path.exists(f1):
        synth.write_fastq_pair(f1, f2, rd)
    prefix = os.path.join(work, "aln" if seed_mode == "hash" else "aln_fm")
    argv = ["align", "-R", "@RG\\tID:smoke\\tSM:smoke", "-o", prefix,
            "--batch-size", str(BATCH), "--device", "cuda",
            "--seed-mode", seed_mode, fasta, f1, f2]
    pipeline._host_cache.clear()   # earlier phases cached the reference
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw_banded.reset_launches()
    fm_search.reset_launches()
    seed_chain.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sw_banded.LAUNCHES)
    on_path = list(launches)
    if seed_mode == "fm":
        launches.update(fm_search.LAUNCHES)
        on_path.append("fm_smem")
    else:
        launches.update(seed_chain.LAUNCHES)
        on_path.append("seed_chain")
    check(rc == 0, f"align CLI returned {rc}")
    for k in on_path:
        check(launches[k] > 0, f"{k} was not launched on the main path")
    snap = metrics.snapshot()
    if seed_mode == "hash":
        # one launch a step, every read through it
        check(launches["seed_chain"] == snap.get("align.batches"),
              "seed_chain did not launch once a step")
        check(snap.get("align.seed_chain.kernel_reads")
              == snap.get("align.reads"),
              "not every read went through the seed_chain kernel")
    device_s = float(snap.get("align.device_step_s", 0.0))
    index_s = float(snap.get("time.align.index_load", 0.0))
    check(index_s > 0, "the index load was not timed")
    n_reads = 2 * PAIRS
    counts = {}
    for suffix in (".bam", ".splitters.bam", ".discordants.bam"):
        _, recs = read_records(prefix + suffix)
        counts[suffix[1:]] = len(recs)
        if suffix == ".bam":
            main = recs
    check(counts["splitters.bam"] > 0, "no splitters from the deletions")
    truth = {}
    for i, nm in enumerate(rd.names):
        truth[(nm, 1)] = (int(rd.tid1[i]), int(rd.pos1[i]))
        truth[(nm, 2)] = (int(rd.tid2[i]), int(rd.pos2[i]))
    prim = [r for r in main if not r.flag & (FSECONDARY | FSUPPLEMENTARY)]
    check(len(prim) == n_reads, f"{len(prim)} primary records, want {n_reads}")
    mapped = [r for r in prim if not r.flag & FUNMAP]
    good = sum(
        1 for r in mapped
        if (lambda t: t[0] == r.tid and abs(r.pos - t[1]) <= 12)(
            truth[(r.qname, 1 if r.flag & FREAD1 else 2)]))
    mapped_frac = len(mapped) / n_reads
    acc = good / max(1, len(mapped))
    killed = set(np.nonzero(rd.killed)[0].tolist())
    killed_names = {rd.names[i] for i in killed}
    rescued = sum(1 for r in mapped if not r.flag & FREAD1
                  and r.qname in killed_names)
    emit({"phase": "align", "seed_mode": seed_mode, "pairs": PAIRS,
          "read_len": 150,
          "batch_size": BATCH, "wall_s": wall,
          "reads_per_s": n_reads / wall,
          "index_load_s": index_s,
          "reads_per_s_after_index_load": n_reads / (wall - index_s),
          "device_step_s": device_s,
          "device_step_share": device_s / wall,
          "device_step_share_after_index_load": device_s / (wall - index_s),
          "launches": launches, "records": counts,
          "mapped_frac": mapped_frac, "pos_within_12bp": acc,
          "seed_killed_r2": len(killed), "seed_killed_r2_mapped": rescued,
          "metrics": snap,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(mapped_frac >= 0.95, f"mapped fraction {mapped_frac:.4f} < 0.95")
    check(acc >= 0.95, f"position accuracy {acc:.4f} < 0.95")
    check(rescued > 0, "no seed-killed read-2 end was rescued")
    return launches


def _cigar_unbanded_bound(q, ql, r, clock_hz, n_sms, max_ops=48):
    """The least time of the traceback DP on these inputs: the rows it
    runs x Lr cells x ops/sw_unbanded.py:OPS_PER_CELL_CIGAR int32
    instructions, or its bytes (query, qlen and window read once; eight
    int32 outputs, the int8 ops and the int32 lengths written)."""
    import numpy as np

    from speedseq_tpu_torch.ops import sw_unbanded

    q, ql, r = (a.cpu().numpy() for a in (q, ql, r))
    n, Lq = q.shape
    rows = np.clip(ql.astype(np.int64), 0, Lq).sum()
    return _ops_bound(
        float(rows) * r.shape[1] * sw_unbanded.OPS_PER_CELL_CIGAR, 0,
        4.0 * (q.size + ql.size + r.size) + n * (8 * 4 + max_ops * 5),
        clock_hz, n_sms)


def phase_unfused(work, fasta, genome, args, clock_hz, n_sms):
    """The unfused alignment API on cuda at the align cell's width: read 1
    of one align-cell batch (UNFUSED_READS reads of 150 bp) through
    ``align_candidates`` (n_chains 4: one launch of ssq_sw_unbanded_cigar
    at 32,768 lanes x 150 x 254) on the fm phase's FM index, then
    ``select_alignments`` and ``assemble_records`` on the host: walls,
    the launch count, >= 95 % mapped and >= 95 % within 12 bp of truth,
    the records; the first UNFUSED_PARITY reads' candidates equal to a
    run on cpu; the kernel against its twin on the card at the captured
    launch (bit-equal), wrapper and device ms, the twin's ms and the
    bound.  Returns (the kernels-line record, the launches of the run)."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.align import core, pipeline
    from speedseq_tpu_torch.align.markdup import StreamDupMarker
    from speedseq_tpu_torch.align.pairing import InsertDistro
    from speedseq_tpu_torch.formats.sam import FSUPPLEMENTARY, FUNMAP
    from speedseq_tpu_torch.ops import sw_unbanded

    rd, reads_np, lens_np = _unfused_reads(genome, args)
    B = UNFUSED_READS
    idx, fm, _ = pipeline._load_fm(fasta, torch.device("cuda"), "fm")
    reads = torch.from_numpy(reads_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    core.align_candidates(fm, reads[:64], lens[:64],
                          n_chains=UNFUSED_CHAINS)         # warm-up
    captured = {}

    def keep(query, qlen, ref, params=(1, 4, 6, 1), max_ops=48):
        captured["args"] = tuple(t.clone() for t in (query, qlen, ref))

    torch.cuda.synchronize()
    sw_unbanded.reset_launches()
    t0 = time.perf_counter()
    with _spying(sw_unbanded, "sw_cigar_unbanded", keep):
        cand = core.align_candidates(fm, reads, lens,
                                     n_chains=UNFUSED_CHAINS)
    torch.cuda.synchronize()
    cand_s = time.perf_counter() - t0
    launches = sw_unbanded.LAUNCHES["sw_unbanded_cigar"]
    check(launches == 1, f"sw_unbanded_cigar launched {launches} times in "
          f"one align_candidates call, not once")
    q, ql, r = captured["args"]
    check(tuple(q.shape) + (r.shape[1],) == (B * UNFUSED_CHAINS, 150, 254),
          f"align_candidates launched at {tuple(q.shape)} x {r.shape[1]}")

    t0 = time.perf_counter()
    sel = core.select_alignments(cand, reads_np, lens_np)
    select_s = time.perf_counter() - t0
    offsets = np.asarray(idx.offsets, np.int64)
    truth = offsets[rd.tid1[:B]] + rd.pos1[:B]
    mapped = [k for k, (p, _) in enumerate(sel) if p.aligned]
    good = sum(abs(sel[k][0].pos - int(truth[k])) <= 12 for k in mapped)
    mapped_frac, acc = len(mapped) / B, good / max(1, len(mapped))

    rc = {0: "T", 1: "G", 2: "C", 3: "A"}
    rows = []
    t0 = time.perf_counter()
    for k, (prim, supp) in enumerate(sel):
        seq = "".join("ACGTN"[min(int(c), 4)] for c in reads_np[k])
        qual = pipeline._phred(rd.qual1[k], 150)
        rows.append(pipeline._PairRow(
            name=rd.names[k], seq=seq, qual=qual,
            seq_rc="".join(rc.get(c, "N") for c in
                           (int(x) for x in reads_np[k][::-1])),
            qual_r=qual[::-1], aln=prim, supp=supp,
            tid=int(idx.tid_for_pos(np.array([prim.pos]))[0])
            if prim.aligned else -1))
    main, splitters, discordants = pipeline.assemble_records(
        rows, None, idx, InsertDistro(320.0, 50.0, 120, 520),
        pipeline.AlignConfig(), marker=StreamDupMarker())
    main.sort(key=pipeline.sort_key)
    assemble_s = time.perf_counter() - t0
    n_supp = sum(bool(rec.flag & FSUPPLEMENTARY) for rec in main)
    check(len(main) == B + n_supp, f"{len(main)} records for {B} reads "
          f"and {n_supp} supplementary pieces")
    check(sum(not rec.flag & (FUNMAP | FSUPPLEMENTARY) for rec in main)
          == len(mapped), "the records lost a mapped read")

    # the first UNFUSED_PARITY reads on cpu: the same candidates
    _, fm_cpu, _ = pipeline._load_fm(fasta, torch.device("cpu"), "fm")
    P = UNFUSED_PARITY
    t0 = time.perf_counter()
    cpu = core.align_candidates(fm_cpu, torch.from_numpy(reads_np[:P]),
                                torch.from_numpy(lens_np[:P]),
                                n_chains=UNFUSED_CHAINS)
    cpu_s = time.perf_counter() - t0
    differ = [f for f in cpu._fields if not torch.equal(
        getattr(cand, f)[:P].cpu(), getattr(cpu, f))]
    check(not differ, f"align_candidates cuda vs cpu: {differ} differ")

    # the kernel against its twin at the launch the run gave it
    kern, plain = sw_unbanded.sw_cigar_unbanded, \
        sw_unbanded.sw_cigar_unbanded_plain
    got = [t.cpu() for t in kern(q, ql, r)]
    torch.cuda.synchronize()
    want = [t.cpu() for t in plain(q, ql, r)]
    max_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
    check(max_err == 0 and all(a.dtype == b.dtype for a, b in
                               zip(got, want)),
          f"sw_unbanded_cigar disagrees with its twin ({max_err})")
    del got, want
    ms = cuda_ms(lambda: kern(q, ql, r), reps=10)
    device_ms = cuda_ms(lambda: kern(q, ql, r), reps=10, queued=True)
    plain_ms = cuda_ms(lambda: plain(q, ql, r), reps=1, warmup=1)
    torch.cuda.empty_cache()
    bound = _cigar_unbanded_bound(q, ql, r, clock_hz, n_sms)
    emit({"phase": "unfused", "reads": B, "read_len": 150,
          "n_chains": UNFUSED_CHAINS, "lanes": q.shape[0], "Lq": q.shape[1],
          "Lr": r.shape[1], "align_candidates_s": cand_s,
          "select_alignments_s": select_s, "assemble_records_s": assemble_s,
          "cpu_align_candidates_s": cpu_s, "parity_reads": P,
          "parity_ok": True, "launches": launches,
          "mapped_frac": mapped_frac, "pos_within_12bp": acc,
          "records": len(main), "supplementary": n_supp,
          "splitters": len(splitters), "discordants": len(discordants),
          "kernel": {"bit_equal": True, "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, **bound}})
    check(mapped_frac >= 0.95, f"unfused mapped fraction {mapped_frac:.4f}"
          f" < 0.95")
    check(acc >= 0.95, f"unfused position accuracy {acc:.4f} < 0.95")
    rec = {"name": "sw_unbanded_cigar", "route": "cuda",
           "source": "speedseq_tpu_torch/ops/csrc/sw_unbanded.cu",
           "replaces": "speedseq_tpu/align/sw.py:289",
           "launches": 0, "max_abs_err": max_err, "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "library_ms": None,
           "shape": [q.shape[0], q.shape[1], r.shape[1]]}
    return rec, launches


def phase_realign(work, fasta):
    """realign of the align phase's BAM through the CLI on cuda (the
    kernels' counts set to 0 just before it and read just after), then
    cpu/cuda parity on the parity phase's BAM."""
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.align import pipeline
    from speedseq_tpu_torch.align.pipeline import AlignConfig
    from speedseq_tpu_torch.align.realign import realign
    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.utils.metrics import metrics

    def primaries(path):
        hdr, recs = read_records(path)
        return hdr, recs, {(r.qname, r.flag & 0xC0): (r.tid, r.pos)
                           for r in recs if not r.flag & 0x900}

    src = os.path.join(work, "aln.bam")
    prefix = os.path.join(work, "re")
    pipeline._host_cache.clear()   # a fresh CLI run loads the index
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw_banded.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["realign", "--device", "cuda", "--batch-size", str(BATCH),
                   "-o", prefix, fasta, src])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sw_banded.LAUNCHES)
    snap = metrics.snapshot()
    check(rc == 0, f"realign CLI returned {rc}")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the realign path")
    _, _, before = primaries(src)
    hdr, recs, after = primaries(prefix + ".bam")
    kept = sum(after.get(k) == v for k, v in before.items()) / len(before)
    rg_lines = [l for l in hdr.text.splitlines() if l.startswith("@RG")]
    counts = {}
    for suffix in (".bam", ".splitters.bam", ".discordants.bam"):
        check(os.path.exists(prefix + suffix + ".bai"),
              f"realign wrote no {suffix}.bai")
        counts[suffix[1:]] = (len(recs) if suffix == ".bam"
                              else len(read_records(prefix + suffix)[1]))

    # cpu/cuda parity over the parity phase's BAM
    par = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        out = realign(fasta, [os.path.join(work, "pc.bam")],
                      os.path.join(work, f"re_{dev}"),
                      config=AlignConfig(batch_size=PARITY_BATCH), device=dev)
        par[dev] = ({k: read_records(out[k]) for k in
                     ("bam", "splitters.bam", "discordants.bam")},
                    time.perf_counter() - t0)
    same = all(par["cpu"][0][k][0].text == par["cuda"][0][k][0].text
               and par["cpu"][0][k][1] == par["cuda"][0][k][1]
               for k in par["cpu"][0])
    n_reads = len(before)
    emit({"phase": "realign", "input_pairs": PAIRS, "batch_size": BATCH,
          "wall_s": wall, "reads_per_s": n_reads / wall,
          "index_load_s": snap.get("time.align.index_load", 0.0),
          "extract_s": snap.get("time.realign.extract", 0.0),
          "device_step_s": snap.get("align.device_step_s", 0.0),
          "emit_s": snap.get("time.align.emit", 0.0),
          "pending_peak": snap.get("realign.pending_peak", 0),
          "launches": launches, "records": counts,
          "primaries_in": n_reads, "primaries_out": len(after),
          "placements_kept": kept, "rg_lines": rg_lines,
          "parity_pairs": PARITY_PAIRS, "parity_record_equal": same,
          "parity_cpu_s": par["cpu"][1], "parity_cuda_s": par["cuda"][1],
          "metrics": snap,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(set(after) == set(before), "realign lost or added primary reads")
    check(kept >= 0.98, f"realign kept {kept:.4f} < 0.98 of placements")
    check(rg_lines == ["@RG\tID:smoke\tSM:smoke"] and all(
        r.get_tag("RG") == "smoke" for r in recs),
        "realign did not carry the read group through")
    check(same, "realign: cpu and cuda triples differ")


def phase_var(work, args):
    """var at 1 Mbp x 30x through the CLI on cuda; returns (the haplotype
    scan kernel's launches in that run, the inputs of the largest scan
    call of the cuda parity run, on the card)."""
    import numpy as np
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.formats.fasta import decode_bases
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.utils import sim
    from speedseq_tpu_torch.utils.metrics import metrics
    from speedseq_tpu_torch.utils.somatic_cases import records_mismatch
    from speedseq_tpu_torch.var.engine import VarConfig, run_var
    from speedseq_tpu_torch.var.normalize import left_align, primitives

    rng = np.random.default_rng(args.seed + 200)
    g = rng.integers(0, 4, VAR_BP).astype(np.uint8)
    hap, variants, coord = sim.mutate(g, rng, snv_rate=0.003,
                                      indel_rate=0.0005)
    names, s1, q1, s2, q2, _ = sim.simulate_pairs(
        g, VAR_PAIRS, read_len=150, insert_mean=320.0, insert_std=50.0,
        seed=args.seed + 201, diploid_genome=hap, coord_map=coord)
    fasta = os.path.join(work, "var.fa")
    seq = decode_bases(g).decode()
    with open(fasta, "w") as fh:
        fh.write(">chrV\n" + "\n".join(seq[i:i + 60]
                                       for i in range(0, len(seq), 60)) + "\n")
    f1, f2 = os.path.join(work, "v1.fq"), os.path.join(work, "v2.fq")
    sim.to_fastq(f1, f2, names, s1, q1, s2, q2)
    aln = os.path.join(work, "var_aln")
    t0 = time.perf_counter()
    rc = cli.main(["align", "-R", "@RG\\tID:var\\tSM:var", "-o", aln,
                   "--batch-size", str(BATCH), "--device", "cuda", fasta,
                   f1, f2])
    align_s = time.perf_counter() - t0
    check(rc == 0, f"align CLI for the var input returned {rc}")
    bam = aln + ".bam"

    out = os.path.join(work, "var")
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw_unbanded.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["var", "--device", "cuda", "-o", out, fasta, bam])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sw_unbanded.LAUNCHES["sw_unbanded_score"]
    snap = metrics.snapshot()
    check(rc == 0, f"var CLI returned {rc}")
    check(snap.get("var.windows_failed", 0) == 0, "a var window failed")
    check(snap.get("var.hap_scan_lanes.cuda", 0) > 0,
          "the haplotype scan did not run on cuda")
    check(snap.get("var.genotype_programs.cuda", 0) > 0,
          "the genotyping program did not run on cuda")
    _, recs = read_vcf(out + ".vcf.gz")
    truth = {left_align(g, p, r, a) for p, r, a in variants}
    called = {pr for r in recs for a in r.alt
              for pr in primitives(r.pos, r.ref, a)}
    tp = len(called & truth)
    recall, precision = tp / len(truth), tp / max(1, len(called))

    # parity region: four windows, so -t 4 runs the haplotype scan on the
    # card from four threads at once
    bed = os.path.join(work, "first.bed")
    step = VAR_PARITY_BP // 4
    with open(bed, "w") as fh:
        fh.writelines(f"chrV\t{a}\t{a + step}\n"
                      for a in range(0, VAR_PARITY_BP, step))
    par, raw, scan_in, par_metrics = {}, {}, {}, {}

    def keep(query, qlen, ref, params=(1, 4, 6, 1)):
        if query.is_cuda and query.shape[0] > scan_in.get("n", 0):
            scan_in.update(n=query.shape[0], args=tuple(
                t.clone() for t in (query, qlen, ref)))

    for name, dev, threads in (("cpu", "cpu", 1), ("cuda", "cuda", 1),
                               ("cuda_t4", "cuda", 4)):
        path = os.path.join(work, f"par_{name}.vcf.gz")
        spy = (_spying(sw_unbanded, "sw_score_unbanded", keep)
               if name == "cuda" else contextlib.nullcontext())
        metrics.reset()
        t0 = time.perf_counter()
        with spy:
            run_var(fasta, [bam], path, windows_bed=bed, device=dev,
                    config=VarConfig(threads=threads))
        par[name] = (read_vcf(path)[1], time.perf_counter() - t0)
        # the split of the run (timers summed over threads)
        par_metrics[name] = {k: v for k, v in metrics.snapshot().items()
                             if k.startswith("time.var.")}
        with open(path, "rb") as fh:
            raw[name] = fh.read()
    why = records_mismatch(par["cpu"][0], par["cuda"][0])
    long_reads = _var_long_reads(work, args)

    emit({"phase": "var", "contig_bp": VAR_BP, "pairs": VAR_PAIRS,
          "read_len": 150, "coverage": 2 * 150 * VAR_PAIRS / VAR_BP,
          "align_s": align_s, "wall_s": wall,
          "mbp_per_s": VAR_BP / 1e6 / wall,
          "reads_per_s": 2 * VAR_PAIRS / wall,
          "pileup_s": snap.get("time.var.pileup", 0.0),
          "loci_s": snap.get("time.var.loci", 0.0),
          "emit_s": snap.get("time.var.emit", 0.0),
          "genotype_s": snap.get("time.var.genotype", 0.0),
          "hap_scan_calls": snap.get("var.hap_scan_calls.cuda", 0),
          "hap_scan_lanes": snap.get("var.hap_scan_lanes.cuda", 0),
          "hap_scan_s": snap.get("time.var.hap_scan", 0.0),
          "hap_scan_launches": launches,
          "genotype_programs": snap.get("var.genotype_programs.cuda", 0),
          "windows": snap.get("var.windows", 0),
          "sites": snap.get("var.sites", 0), "records": len(recs),
          "truth_primitives": len(truth), "called_primitives": len(called),
          "recall": recall, "precision": precision,
          "parity_bp": VAR_PARITY_BP, "parity_records": len(par["cuda"][0]),
          "parity_cpu_s": par["cpu"][1], "parity_cuda_s": par["cuda"][1],
          "parity_cuda_t4_s": par["cuda_t4"][1],
          "parity_metrics": par_metrics,
          "parity_ok": why is None,
          "threads_byte_equal": raw["cuda_t4"] == raw["cuda"],
          "long_reads": long_reads,
          "metrics": snap,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(recall >= 0.92, f"var recall {recall:.4f} < 0.92")
    check(precision >= 0.92, f"var precision {precision:.4f} < 0.92")
    check(len(par["cuda"][0]) > 0, "no records in the parity region")
    check(why is None, f"var cpu vs cuda: {why}")
    check(raw["cuda_t4"] == raw["cuda"], "var -t 4 on cuda differs from -t 1")
    check(launches > 0 and launches == snap.get("var.hap_scan_calls.cuda"),
          f"sw_unbanded_score launched {launches} times in the var run, "
          f"not once a scan call")
    return launches, scan_in["args"]


def _var_long_reads(work, args):
    """var through the CLI on cuda and on cpu over a BAM of 1,000 bp reads
    (20x over a VAR_LONG_BP contig whose second haplotype carries SNV
    pairs 1-2 bp apart, the haplotype scan's groups): its windows are Lr
    = 1088 wide, so the wide scan kernel runs.  The records must be equal
    and the kernel launched at a width above 1,024."""
    import numpy as np
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.formats.bai import build_bai
    from speedseq_tpu_torch.formats.bam import write_bam
    from speedseq_tpu_torch.formats.fasta import decode_bases
    from speedseq_tpu_torch.formats.sam import SAMHeader, SAMRecord
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.somatic_cases import records_mismatch

    rng = np.random.default_rng(args.seed + 250)
    g = rng.integers(0, 4, VAR_LONG_BP).astype(np.uint8)
    hap = g.copy()
    for k, p in enumerate(range(1500, VAR_LONG_BP - 1500, 1500)):
        for at in (p, p + 1 + k % 2):
            hap[at] = (hap[at] + 1 + rng.integers(0, 3)) % 4
    fasta = os.path.join(work, "long.fa")
    seq = decode_bases(g).decode()
    with open(fasta, "w") as fh:
        fh.write(">chrL\n" + "\n".join(seq[i:i + 60]
                                       for i in range(0, len(seq), 60)) + "\n")
    n = 20 * VAR_LONG_BP // 1000
    starts = np.sort(rng.integers(0, VAR_LONG_BP - 1000, n))
    recs = [SAMRecord(
        qname=f"long{k}", flag=16 if k % 4 >= 2 else 0, tid=0, pos=int(s),
        mapq=60, cigar=[(0, 1000)], mtid=-1, mpos=-1, tlen=0,
        seq=decode_bases((hap if k % 2 else g)[s:s + 1000]).decode(),
        qual="I" * 1000, tags=[("RG", "Z", "long")])
        for k, s in enumerate(starts)]
    bam = os.path.join(work, "long.bam")
    write_bam(bam, SAMHeader.build([("chrL", VAR_LONG_BP)],
                                   read_groups=["@RG\tID:long\tSM:long"]),
              recs)
    build_bai(bam)
    widths, out = [], {}

    def keep(query, qlen, ref, params=(1, 4, 6, 1)):
        if query.is_cuda:
            widths.append(ref.shape[1])

    walls = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(work, f"long_{dev}")
        sw_unbanded.reset_launches()
        t0 = time.perf_counter()
        with _spying(sw_unbanded, "sw_score_unbanded", keep):
            rc = cli.main(["var", "--device", dev, "-o", path, fasta, bam])
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
        check(rc == 0, f"var --device {dev} on 1,000 bp reads returned {rc}")
        out[dev] = (read_vcf(path + ".vcf.gz")[1],
                    sw_unbanded.LAUNCHES["sw_unbanded_score"])
    why = records_mismatch(out["cpu"][0], out["cuda"][0])
    res = {"contig_bp": VAR_LONG_BP, "reads": n, "read_len": 1000,
           "records": len(out["cuda"][0]), "scan_widths": sorted(set(widths)),
           "launches_cuda": out["cuda"][1], "launches_cpu": out["cpu"][1],
           "wall_cuda_s": walls["cuda"], "wall_cpu_s": walls["cpu"],
           "parity_ok": why is None}
    check(len(out["cuda"][0]) > 0, "no records from the 1,000 bp reads")
    check(why is None, f"var on 1,000 bp reads, cpu vs cuda: {why}")
    check(out["cuda"][1] == len(widths) > 0 and min(widths) > 1024,
          f"the wide scan did not run: widths {sorted(set(widths))}, "
          f"{out['cuda'][1]} launches")
    check(out["cpu"][1] == 0, "the cpu run launched the scan kernel")
    return res


def phase_somatic(work, args):
    """somatic at 1 Mbp (30x + 60x) through the CLI on cuda; returns the
    haplotype scan kernel's launches in that run."""
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.utils import somatic_cases
    from speedseq_tpu_torch.utils.metrics import metrics
    from speedseq_tpu_torch.var.somatic import SomaticConfig, run_somatic

    t0 = time.perf_counter()
    case = somatic_cases.tumor_normal(SOM_BP, SOM_NORMAL_PAIRS,
                                      SOM_TUMOR_PAIRS, seed=args.seed + 400)
    fasta = os.path.join(work, "som.fa")
    somatic_cases.write_fasta(fasta, "chrS", case.genome)
    gtf = os.path.join(work, "som.gtf")
    somatic_cases.write_gtf(gtf, "chrS", SOM_BP, SOM_GENES, seed=args.seed)
    bams = {}
    for name, reads in (("normal", case.normal), ("tumor", case.tumor)):
        f1, f2 = somatic_cases.write_fastqs(os.path.join(work, name), reads)
        sm = name.upper()
        rc = cli.main(["align", "-R", f"@RG\\tID:{sm[0]}\\tSM:{sm}", "-o",
                       os.path.join(work, name), "--batch-size", str(BATCH),
                       "--device", "cuda", fasta, f1, f2])
        check(rc == 0, f"align CLI for the {name} input returned {rc}")
        bams[name] = os.path.join(work, name + ".bam")
    setup_s = time.perf_counter() - t0

    out = os.path.join(work, "som")
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw_unbanded.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["somatic", "--device", "cuda", "-t", "1", "--gff", gtf,
                   "-o", out, fasta, bams["normal"], bams["tumor"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sw_unbanded.LAUNCHES["sw_unbanded_score"]
    snap = metrics.snapshot()
    check(rc == 0, f"somatic CLI returned {rc}")
    check(snap.get("var.windows_failed", 0) == 0, "a somatic window failed")
    check(snap.get("var.hap_scan_lanes.cuda", 0) > 0,
          "the haplotype scan did not run on cuda")
    check(snap.get("var.genotype_programs.cuda", 0) > 0,
          "the genotyping program did not run on cuda")
    hdr, recs = read_vcf(out + ".vcf.gz")
    passed = [r for r in recs if r.filter == "PASS"]
    truth = {p for p, _, _ in case.somatic}
    germ = {p for p, _, _ in case.germline}
    tp = sum(r.pos in truth for r in passed)
    recall, precision = tp / len(truth), tp / max(1, len(passed))
    csq = [r.info.get("CSQ", "").split(",")[0].split("|") for r in recs]
    coding = sum(f[0] in ("missense_variant", "synonymous_variant",
                          "stop_gained", "stop_lost", "start_lost")
                 for f in csq)
    with open(out + ".ped") as fh:
        ped = fh.read()

    # parity region: four windows, so -t 4 runs the haplotype scan and the
    # genotyping program from four threads at once
    bed = os.path.join(work, "som_first.bed")
    step = VAR_PARITY_BP // 4
    with open(bed, "w") as fh:
        fh.writelines(f"chrS\t{a}\t{a + step}\n"
                      for a in range(0, VAR_PARITY_BP, step))
    par, raw = {}, {}
    for name, dev, threads in (("cpu", "cpu", 1), ("cuda", "cuda", 1),
                               ("cuda_t4", "cuda", 4)):
        path = os.path.join(work, f"som_{name}.vcf.gz")
        t0 = time.perf_counter()
        run_somatic(fasta, bams["normal"], bams["tumor"], path,
                    windows_bed=bed, config=SomaticConfig(threads=threads),
                    device=dev)
        par[name] = (read_vcf(path)[1], time.perf_counter() - t0)
        with open(path, "rb") as fh:
            raw[name] = fh.read()
    why = (somatic_cases.records_mismatch(par["cpu"][0], par["cuda"][0])
           or somatic_cases.records_mismatch(par["cuda"][0],
                                             par["cuda_t4"][0]))
    n_reads = 2 * (SOM_NORMAL_PAIRS + SOM_TUMOR_PAIRS)
    emit({"phase": "somatic", "contig_bp": SOM_BP,
          "normal_pairs": SOM_NORMAL_PAIRS, "tumor_pairs": SOM_TUMOR_PAIRS,
          "read_len": 150,
          "coverage": [2 * 150 * n / SOM_BP for n in (SOM_NORMAL_PAIRS,
                                                     SOM_TUMOR_PAIRS)],
          "germline_snvs": len(germ), "somatic_snvs": len(truth),
          "setup_s": setup_s, "wall_s": wall,
          "mbp_per_s": SOM_BP / 1e6 / wall, "reads_per_s": n_reads / wall,
          "pileup_s": snap.get("time.var.pileup", 0.0),
          "loci_s": snap.get("time.var.loci", 0.0),
          "hap_scan_s": snap.get("time.var.hap_scan", 0.0),
          "genotype_s": snap.get("time.var.genotype", 0.0),
          "emit_s": snap.get("time.var.emit", 0.0),
          "annotate_s": snap.get("time.annotate", 0.0),
          "genotype_programs": snap.get("var.genotype_programs.cuda", 0),
          "hap_scan_lanes": snap.get("var.hap_scan_lanes.cuda", 0),
          "hap_scan_launches": launches,
          "records": len(recs), "pass": len(passed),
          "non_pass": len(recs) - len(passed),
          "recall": recall, "precision": precision,
          "coding_records": coding,
          "parity_bp": VAR_PARITY_BP, "parity_records": len(par["cuda"][0]),
          "parity_cpu_s": par["cpu"][1], "parity_cuda_s": par["cuda"][1],
          "parity_cuda_t4_s": par["cuda_t4"][1], "parity_ok": why is None,
          "threads_byte_equal": raw["cuda_t4"] == raw["cuda"],
          "metrics": snap,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(recall >= 0.6, f"somatic recall {recall:.4f} < 0.6")
    check(precision >= 0.9, f"somatic precision {precision:.4f} < 0.9")
    check(not any(r.pos in germ for r in passed),
          "a germline site was called PASS")
    check(all(r.samples[0]["GT"] == "0/0" for r in passed),
          "a PASS record has a non-reference normal")
    check(all(next(iter(r.info)) == "SSC" for r in recs),
          "SSC is not first in INFO on every record")
    check(any(l.startswith("##INFO=<ID=SSC") for l in hdr.lines),
          "the header does not declare SSC")
    check("NORMAL" in ped and "TUMOR" in ped, "the PED file lacks a sample")
    check(all(len(f) == 11 for f in csq), "a record lacks an 11-field CSQ")
    check(coding > 0, "no record has a coding consequence")
    check(len(par["cuda"][0]) > 0, "no records in the somatic parity region")
    check(why is None, f"somatic cpu vs cuda vs cuda -t 4: {why}")
    check(launches > 0 and launches == snap.get("var.hap_scan_calls.cuda"),
          f"sw_unbanded_score launched {launches} times in the somatic run, "
          f"not once a scan call")
    return launches


def _sv_mismatch(a, b):
    """None when two sv record lists agree under the rules of
    tests/test_torch_sv.py (sites, INFO and FORMAT counts equal; PRPOS and
    PREND within atol 2e-5 + one unit of their third digit; GQ within 1,
    SQ within 0.05, GL within 1); else why."""
    if len(a) != len(b):
        return f"{len(a)} vs {len(b)} records"
    fl = lambda v: [float(x) for x in str(v).split(",")]
    for x, y in zip(a, b):
        where = f"{x.chrom}:{x.pos}"
        if (x.chrom, x.pos, x.id, x.alt) != (y.chrom, y.pos, y.id, y.alt):
            return f"{where}: site differs"
        for k in ("SVTYPE", "SVLEN", "END", "STRANDS", "CIPOS", "CIEND",
                  "CIPOS95", "CIEND95", "SU", "PE", "SR", "IMPRECISE",
                  "MATEID", "EVENT"):
            if x.info.get(k) != y.info.get(k):
                return f"{where}: INFO {k} {x.info.get(k)} vs {y.info.get(k)}"
        for k in ("PRPOS", "PREND"):
            p, q = fl(x.info[k]), fl(y.info[k])
            if len(p) != len(q) or any(abs(u - v) > 2e-5 + 1e-2 * abs(v)
                                       for u, v in zip(p, q)):
                return f"{where}: {k} differs"
        for sx, sy in zip(x.samples, y.samples):
            for k in ("GT", "SU", "PE", "SR", "DP", "RO", "AO", "RS", "AS",
                      "RP", "AP", "AB", "CN"):
                if sx.get(k) != sy.get(k):
                    return f"{where}: FORMAT {k} {sx.get(k)} vs {sy.get(k)}"
            if (abs(int(sx["GQ"]) - int(sy["GQ"])) > 1
                    or abs(float(sx["SQ"]) - float(sy["SQ"])) > 0.05
                    or max(abs(u - v) for u, v in zip(fl(sx["GL"]),
                                                      fl(sy["GL"]))) > 1):
                return f"{where}: GQ/SQ/GL {sx} vs {sy}"
    return None


def _readdepth_mismatch(pa, pb):
    """None when two readdepth.txt files hold the same calls (kind and
    region) with norm_rd within rtol 1e-4."""
    rows = []
    for p in (pa, pb):
        with open(p) as fh:
            rows.append([l.split("\t") for l in fh.read().splitlines()])
    if len(rows[0]) != len(rows[1]):
        return f"{len(rows[0])} vs {len(rows[1])} readdepth calls"
    for x, y in zip(*rows):
        if x[:3] != y[:3] or abs(float(x[3]) - float(y[3])) > 1e-4 * abs(
                float(y[3])):
            return f"readdepth {x[:4]} vs {y[:4]}"
    return None


def _sv_truth_match(recs, events, ta, tb, names):
    """Match sv records to the planted events.  Returns (per-event matched
    flags, per-junction matched flags, calls as (kind, matched, GT, CN))."""
    kinds = {}
    calls = []
    bnd = {}
    for r in recs:
        t = r.info["SVTYPE"]
        if t == "BND":
            bnd.setdefault(r.info["EVENT"], []).append(r)
            continue
        end = int(r.info["END"])
        hit = [i for i, (k, tid, s, ln) in enumerate(events)
               if k == t and names[tid] == r.chrom
               and abs(r.pos - s) <= SV_SLACK
               and abs(end - (s + ln)) <= SV_SLACK]
        for i in hit:
            kinds[i] = True
        calls.append((t, bool(hit), r.samples[0].get("GT"),
                      r.samples[0].get("CN")))
    junctions = set()
    for ev_recs in bnd.values():
        r = ev_recs[0]
        at = {r.chrom: r.pos}
        mate = r.alt[0].strip("N[]").split(":")
        at[mate[0]] = int(mate[1]) - 1
        hit = (names[0] in at and names[1] in at
               and abs(at[names[0]] - ta) <= SV_SLACK
               and abs(at[names[1]] - tb) <= SV_SLACK)
        if hit:
            junctions.add(r.info["STRANDS"].split(":")[0])
        calls.append(("BND", hit, r.samples[0].get("GT"), None))
    return ([i in kinds for i in range(len(events))], junctions, calls)


def _sv_aligned(work, args):
    """The sv phase's input: two contigs carrying the planted SVs, 30x of
    pairs from both haplotypes aligned by the port's CLI on cuda."""
    import numpy as np

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.formats.fasta import decode_bases
    from speedseq_tpu_torch.utils import sim, sv_cases

    rng = np.random.default_rng(args.seed + 300)
    contigs, alts, events, (ta, tb) = sv_cases.plant_svs(SV_BP, rng)
    names = ["chrA", "chrB"]
    fasta = os.path.join(work, "sv.fa")
    with open(fasta, "w") as fh:
        for nm, c in zip(names, contigs):
            seq = decode_bases(c).decode()
            fh.write(f">{nm}\n" + "\n".join(seq[i:i + 60]
                                            for i in range(0, len(seq), 60))
                     + "\n")
    # half the pairs from each haplotype, each of its contigs in
    # proportion to length (the alternates are chimeric, so their lengths
    # differ from the reference contigs'): 15x per haplotype everywhere
    reads = [[], [], [], [], []]
    for h, seq in enumerate(contigs + alts):
        hap = contigs if h < 2 else alts
        n_h = SV_PAIRS // 2 * len(seq) // sum(len(s) for s in hap)
        out = sim.simulate_pairs(
            seq, n_h, read_len=150, insert_mean=320.0, insert_std=50.0,
            seed=args.seed + 301 + h, name_prefix=f"h{h}")
        for k in range(5):
            reads[k].append(out[k])
    f1, f2 = os.path.join(work, "sv1.fq"), os.path.join(work, "sv2.fq")
    sim.to_fastq(f1, f2, sum(reads[0], []),
                 *(np.concatenate(r) for r in reads[1:]))
    n_pairs = sum(len(r) for r in reads[0])
    aln = os.path.join(work, "sv_aln")
    t0 = time.perf_counter()
    rc = cli.main(["align", "-R", "@RG\\tID:sv\\tSM:sv", "-o", aln,
                   "--batch-size", str(BATCH), "--device", "cuda", fasta,
                   f1, f2])
    align_s = time.perf_counter() - t0
    check(rc == 0, f"align CLI for the sv input returned {rc}")
    return {"fasta": fasta, "names": names, "events": events, "ta": ta,
            "tb": tb, "aln": aln, "n_pairs": n_pairs, "align_s": align_s}


def _sv_evidence(sv):
    """The sv phase's evidence rows (_sv_aligned's BAM triple)."""
    from speedseq_tpu_torch.sv.evidence import InsertStats, collect_evidence

    aln = sv["aln"]
    stats = InsertStats.from_bam(aln + ".bam")
    return collect_evidence([aln + ".discordants.bam"],
                            [aln + ".splitters.bam"], [stats],
                            ref_names=sv["names"])


def _sweep_cols(sv):
    """The sweep's inputs (gid, s1, e1, lo2, hi2) of the sv phase's
    evidence, sorted as ``evidence_columns`` sorts them."""
    import numpy as np

    from speedseq_tpu_torch.sv.cluster import evidence_columns

    _, gid, s1, l1, _, s2, l2, _ = evidence_columns(_sv_evidence(sv))
    return tuple(np.asarray(c, np.int32)
                 for c in (gid, s1, s1 + l1, s2, s2 + l2))


def phase_sv(work, args):
    """sv at 2 Mbp × 30x through the CLI on cuda; returns (the sweep and
    curve-combination kernels' launches in that run, the run's sorted
    sweep inputs, the combination kernel's inputs of the cuda parity run,
    one a side, on the card)."""
    import numpy as np
    import torch

    from speedseq_tpu_torch import cli
    from speedseq_tpu_torch.formats.vcf import read_vcf
    from speedseq_tpu_torch.ops import sv_cluster, sv_combine
    from speedseq_tpu_torch.sv.engine import SVConfig, SVSample, run_sv
    from speedseq_tpu_torch.utils.metrics import metrics

    sv = _sv_aligned(work, args)
    fasta, names, events = sv["fasta"], sv["names"], sv["events"]
    ta, tb, n_pairs, align_s = sv["ta"], sv["tb"], sv["n_pairs"], sv["align_s"]
    aln = sv["aln"]
    total_bp = sum(SV_BP)
    bam = aln + ".bam"

    # the combination library's one-time costs, apart from the run: its
    # load (ctypes), then its first and second launch on one 1-cell cluster
    one_time = {}
    t0 = time.perf_counter()
    sv_combine._load()
    one_time["combine_load_s"] = time.perf_counter() - t0
    tiny = [torch.zeros(1, dtype=torch.int32, device="cuda")
            for _ in range(5)]
    tiny[1] += 1                                   # sizes
    tiny[4] += 1                                   # clen
    tiny.append(torch.ones((1, 1), device="cuda"))  # curves
    for k in ("combine_first_launch_s", "combine_second_launch_s"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv_combine.combine_logsum(*tiny, 1)
        torch.cuda.synchronize()
        one_time[k] = time.perf_counter() - t0

    out = os.path.join(work, "sv")
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sv_cluster.reset_launches()
    sv_combine.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["sv", "--device", "cuda", "-g", "-d", "-P", "-R", fasta,
                   "-B", bam, "-o", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**sv_cluster.LAUNCHES, **sv_combine.LAUNCHES}
    snap = metrics.snapshot()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"sv CLI returned {rc}")
    for k in ("cluster_scans", "svtyper_programs", "depth_programs"):
        check(snap.get(f"sv.{k}.cuda", 0) > 0, f"sv.{k} did not run on cuda")
    check(launches["sv_cluster"] > 0, "sv_cluster was not launched on the "
          "main path")
    check(launches["sv_combine_logsum"] == 2 * snap.get(
        "sv.cluster_scans.cuda", 0), "sv_combine_logsum was not launched "
          "once a side of each cluster pass on the main path")
    _, recs = read_vcf(out + ".sv.vcf.gz")
    ev_hit, junctions, calls = _sv_truth_match(recs, events, ta, tb, names)
    recall = (sum(ev_hit) + min(len(junctions), 2)) / (len(events) + 2)
    matched = [c for c in calls if c[1]]
    precision = len(matched) / max(1, len(calls))
    nonref = sum(1 for c in matched if c[2] in ("0/1", "1/1"))
    cn = lambda kind: [float(c[3]) for c in matched if c[0] == kind]
    med = lambda v: float(np.median(v)) if v else None

    # cpu/cuda parity over the same BAM triple
    spl, disc = aln + ".splitters.bam", aln + ".discordants.bam"
    par, combine_in = {}, []
    keep = lambda *a: combine_in.append(tuple(
        t.clone() if torch.is_tensor(t) else t for t in a))
    for dev in ("cpu", "cuda"):
        path = os.path.join(work, f"svpar_{dev}.sv.vcf.gz")
        metrics.reset()      # the cuda run's timers: sv once the card is warm
        spy = (_spying(sv_combine, "combine_logsum", keep) if dev == "cuda"
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with spy:
            run_sv([SVSample("sv", bam, spl, disc)], path,
                   SVConfig(genotype=True, annotate_depth=True,
                            prob_curves=True, reference=fasta), device=dev)
        par[dev] = (read_vcf(path)[1], time.perf_counter() - t0,
                    path[:-7] + ".sv.readdepth.txt")
    why = (_sv_mismatch(par["cpu"][0], par["cuda"][0])
           or _readdepth_mismatch(par["cpu"][2], par["cuda"][2]))

    emit({"phase": "sv", "contig_bp": list(SV_BP), "pairs": n_pairs,
          "read_len": 150, "coverage": 2 * 150 * n_pairs / total_bp,
          "events": len(events), "translocation": [ta, tb],
          "align_s": align_s, "wall_s": wall,
          "mbp_per_s": total_bp / 1e6 / wall,
          "reads_per_s": 2 * n_pairs / wall,
          "insert_stats_s": snap.get("time.sv.insert_stats", 0.0),
          "evidence_s": snap.get("time.sv.evidence", 0.0),
          "cluster_s": snap.get("time.sv.cluster", 0.0),
          "cluster_sweep_s": snap.get("time.sv.cluster_sweep", 0.0),
          "cluster_combine_s": snap.get("time.sv.cluster_combine", 0.0),
          **one_time,
          "svtyper_s": snap.get("time.sv.svtyper", 0.0),
          "cnv_s": snap.get("time.sv.cnv", 0.0),
          "emit_s": snap.get("time.sv.emit", 0.0),
          "evidence_pe": snap.get("sv.evidence.pe", 0),
          "evidence_sr": snap.get("sv.evidence.sr", 0),
          "calls": snap.get("sv.calls", 0), "records": len(recs),
          "launches": launches,
          "events_found": sum(ev_hit), "junctions_found": sorted(junctions),
          "recall": recall, "precision": precision,
          "matched_calls": len(matched), "called": len(calls),
          "nonref_share": nonref / max(1, len(matched)),
          "median_cn_del": med(cn("DEL")), "median_cn_dup": med(cn("DUP")),
          "parity_cpu_s": par["cpu"][1], "parity_cuda_s": par["cuda"][1],
          "parity_records": len(par["cuda"][0]), "parity_ok": why is None,
          "metrics": snap, "warm_cuda_metrics": metrics.snapshot(),
          "max_memory_allocated": peak})
    check(recall >= 0.9, f"sv recall {recall:.4f} < 0.9")
    check(precision >= 0.9, f"sv precision {precision:.4f} < 0.9")
    check(nonref >= 0.9 * len(matched), "under 90 % of matched sv calls "
          "genotyped non-ref")
    check(med(cn("DEL")) is not None and med(cn("DEL")) < 1.5,
          f"median CN over matched deletions {med(cn('DEL'))}")
    check(med(cn("DUP")) is not None and med(cn("DUP")) > 2.5,
          f"median CN over matched duplications {med(cn('DUP'))}")
    check(why is None, f"sv cpu vs cuda: {why}")

    return launches, _sweep_cols(sv), combine_in


MULTI_PAIRS = 32_768                # multi: 4 align-cell batches, 2 waves
MULTI_INSERT = "320,50,520,120"    # -I of the two-process align runs


def _workers(args, what):
    """Two worker processes of ``python -m speedseq_tpu_torch.parallel.
    multihost`` (``args`` with "{pid}" for the process id) on cuda:0,
    exchanging over gloo; their wall and their stdout lines.  A worker
    that fails or outlives its limit fails the phase (both are killed)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, SSQ_COORDINATOR=f"localhost:{port}",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "speedseq_tpu_torch.parallel.multihost"]
        + [a.replace("{pid}", str(p)) for a in args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    check(outs is not None, f"{what}: a worker ran past 300 s")
    for p, (_, err) in zip(procs, outs):
        check(p.returncode == 0,
              f"{what}: worker exit {p.returncode}: {err[-2000:]}")
    lines = [o.strip().splitlines() for o, _ in outs]
    check(all(any("CollectiveExchange on cuda:0" in l for l in ls)
              for ls in lines), f"{what}: a worker was not on gloo, cuda:0")
    return wall, lines


def _worker_launches(lines):
    """Each worker's kernel launch counts, from its worker line."""
    out = []
    for ls in lines:
        tail = [l for l in ls if "launches {" in l]
        out.append(json.loads(tail[-1].split("launches ", 1)[1])
                   if tail else {})
    return out


def _vcf_text(path):
    import gzip

    with gzip.open(path, "rt") as fh:
        return fh.read()


def phase_multi(work, args, smi):
    """Sharded and multi-process runs on the one card: the mesh step on
    [cuda:0] * 2 and on every visible card, coordinate_reshard, sharded
    genotyping and SVTyper, and two worker processes sharing cuda:0 over
    gloo for align (merged and resharded), var, somatic and sv, each held
    to the single-device, single-process result."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.align import core, pipeline
    from speedseq_tpu_torch.formats import fastq
    from speedseq_tpu_torch.ops import sw_banded
    from speedseq_tpu_torch.parallel import mesh as pmesh
    from speedseq_tpu_torch.sv import cluster as svcluster
    from speedseq_tpu_torch.sv.engine import SVConfig, SVSample, run_sv
    from speedseq_tpu_torch.sv.evidence import InsertStats, collect_evidence
    from speedseq_tpu_torch.sv.svtyper import SVGenotyper
    from speedseq_tpu_torch.var import device as vdevice
    from speedseq_tpu_torch.var.engine import run_var

    walls, checks = {}, {}
    t_phase = time.perf_counter()

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    # -- the mesh step on one align-cell batch
    fasta = os.path.join(work, "genome.fa")
    f1, f2 = os.path.join(work, "a1.fq"), os.path.join(work, "a2.fq")
    _, fm, kidx = pipeline._load_fm(fasta, torch.device("cuda"))
    b1, b2 = next(iter(fastq.iter_batches(f1, batch_size=BATCH, max_len=151,
                                          paired_with=f2)))
    step_in = [torch.from_numpy(a).cuda() for a in (
        b1.seq, b1.length.astype(np.int32), b2.seq,
        b2.length.astype(np.int32))]
    one = timed("step_single", lambda: core.fused_align_packed(
        fm, *step_in, kidx=kidx))
    one_aligned = int(((one[0][:, 3, :, 0] & 0xFFFF) >= 30).sum())
    xa = lambda m: {(e,) + tuple(m[e, :, j].tolist())
                    for e in range(m.shape[0])
                    for j in torch.nonzero(m[e, 0] >= 0).flatten().tolist()}
    sw_banded.reset_launches()
    for name, devs in (("mesh_cuda0x2", ["cuda:0"] * 2),
                       ("mesh_all_cards", None)):
        mesh = pmesh.make_mesh(devices=devs)
        got = timed(name, lambda: pmesh.distributed_fused_step(
            mesh, fm, *step_in, kidx=kidx))
        checks[name] = (all(torch.equal(one[k], got[k]) for k in (0, 1, 2, 4))
                        and int(one[3]) == int(got[3])
                        and xa(one[5].cpu()) == xa(got[5].cpu())
                        and got[7] == one_aligned)
    mesh_launches = dict(sw_banded.LAUNCHES)
    check(all(v > 0 for v in mesh_launches.values()),
          f"a SW kernel was not launched by the mesh step: {mesh_launches}")

    # -- coordinate_reshard: two shards of cuda:0 against two of the CPU
    rng = np.random.default_rng(args.seed + 500)
    n_local, span = 1 << 16, 1 << 40
    keys = rng.integers(0, span, (2, n_local)).astype(np.int64)
    keys[:, -1000:] = int(pmesh.KEY_SENTINEL)
    rows = rng.integers(0, 1 << 30, (2, n_local, 3)).astype(np.int64)
    bounds = np.asarray([span // 3], np.int64)
    for cap in (n_local, n_local // 4):
        want = pmesh.coordinate_reshard(
            pmesh.make_mesh(devices=["cpu"] * 2), keys, rows, bounds, cap)
        got = timed(f"reshard_cap{cap}", lambda: pmesh.coordinate_reshard(
            pmesh.make_mesh(devices=["cuda:0"] * 2), keys, rows, bounds,
            cap))
        checks[f"reshard_cap{cap}"] = all(
            torch.equal(a, b.cpu()) for a, b in zip(want, got))
    checks["reshard_dropped"] = bool(got[3].sum() > 0)

    # -- sharded genotyping on the var phase's parity region
    var_fa, var_bam = os.path.join(work, "var.fa"), os.path.join(
        work, "var_aln.bam")
    var_bed = os.path.join(work, "first.bed")
    seen = []
    real = vdevice.genotype_sites

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    vdevice.genotype_sites = spy
    try:
        run_var(var_fa, [var_bam], os.path.join(work, "multi_gt.vcf.gz"),
                windows_bed=var_bed, device="cuda")
    finally:
        vdevice.genotype_sites = real
    check(len(seen) > 0, "no genotyping call to shard")
    gt_ok, sites = True, 0
    mesh2 = pmesh.make_mesh(devices=["cuda:0"] * 2)
    for a, k in seen:
        k = {key: v for key, v in k.items() if key not in ("device",
                                                           "mesh")}
        u = real(*a, device="cuda", **k)
        sh = timed("genotype_sharded", lambda: real(*a, mesh=mesh2, **k))
        sites += len(u.qual)
        gt_ok &= all(np.array_equal(x, y) for x, y in zip(u[:-1], sh[:-1]))
    checks["genotype_sharded"] = gt_ok

    # -- sharded SVTyper on the sv phase's calls
    aln = os.path.join(work, "sv_aln")
    sv_bam = aln + ".bam"
    stats = InsertStats.from_bam(sv_bam)
    ev = collect_evidence([aln + ".discordants.bam"],
                          [aln + ".splitters.bam"], [stats],
                          ref_names=["chrA", "chrB"])
    calls = svcluster.cluster_breakpoints(ev, device="cuda")
    g = SVGenotyper(sv_bam, stats, device="cuda")
    g_one = timed("svtyper_single", lambda: g.genotype_all(calls))
    g_two = timed("svtyper_sharded", lambda: g.genotype_all(calls,
                                                            mesh=mesh2))
    checks["svtyper_sharded"] = g_one == g_two and len(calls) > 0
    g.close()

    # -- two processes on cuda:0: align, merged and resharded
    m1, m2 = (os.path.join(work, f"m{k}.fq") for k in (1, 2))
    for src, dst in ((f1, m1), (f2, m2)):
        with open(src) as fi, open(dst, "w") as fo:
            for _ in range(4 * MULTI_PAIRS):
                fo.write(fi.readline())
    ins = tuple(float(x) for x in MULTI_INSERT.split(","))
    cfg = pipeline.AlignConfig(batch_size=BATCH, insert_override=(
        ins[0], ins[1], int(ins[2]), int(ins[3])))
    single = timed("align_single", lambda: pipeline.align_fastq(
        fasta, m1, m2, out_prefix=os.path.join(work, "m_single"),
        config=cfg, device="cuda"))
    worker_launches = {}
    for mode in ("merged", "resharded"):
        pre = os.path.join(work, f"m_{mode}")
        walls[f"align_2proc_{mode}"], lines = _workers(
            ["align", fasta, m1, m2, pre, "2", "{pid}",
             os.path.join(work, f"ex_{mode}"), str(BATCH), MULTI_INSERT,
             f"smoke_{mode}"] + (["reshard"] if mode == "resharded" else []),
            f"align {mode}")
        outs = json.loads(lines[0][-1])
        checks[f"align_2proc_{mode}"] = all(
            read_records(single[k])[1] == read_records(outs[k])[1]
            and read_records(single[k])[0].text
            == read_records(outs[k])[0].text
            for k in ("bam", "splitters.bam", "discordants.bam"))
        worker_launches[f"align_{mode}"] = _worker_launches(lines)
        check(all(w.get("sw_cigar", 0) > 0 and w.get("sw_score", 0) > 0
                  for w in worker_launches[f"align_{mode}"]),
              f"align {mode}: a worker launched no SW kernel")

    # -- var and somatic over the phases' first 200 kb
    out = os.path.join(work, "m_var.vcf.gz")
    walls["var_2proc"], _ = _workers(
        ["var", var_fa, var_bam, out, "2", "{pid}",
         os.path.join(work, "ex_var"), "smoke_var", "--bed", var_bed], "var")
    checks["var_2proc"] = (_vcf_text(out) == _vcf_text(
        os.path.join(work, "par_cuda.vcf.gz")))
    som_fa = os.path.join(work, "som.fa")
    som_bams = [os.path.join(work, n + ".bam") for n in ("normal", "tumor")]
    out = os.path.join(work, "m_som.vcf.gz")
    walls["somatic_2proc"], _ = _workers(
        ["var", som_fa, ",".join(som_bams), out, "2", "{pid}",
         os.path.join(work, "ex_som"), "smoke_som", "somatic", "--bed",
         os.path.join(work, "som_first.bed")], "somatic")
    with open(out[:-7] + ".ped") as fa_, open(os.path.join(
            work, "som_cuda.ped")) as fb_:
        same_ped = fa_.read() == fb_.read()
    checks["somatic_2proc"] = same_ped and (_vcf_text(out) == _vcf_text(
        os.path.join(work, "som_cuda.vcf.gz")))

    # -- sv with the sv phase's BAM as two samples
    samples = [SVSample(n, sv_bam, aln + ".splitters.bam",
                        aln + ".discordants.bam") for n in ("S1", "S2")]
    sv_one = os.path.join(work, "m_sv_single.sv.vcf.gz")
    timed("sv_single_2samples", lambda: run_sv(samples, sv_one, SVConfig(),
                                               device="cuda"))
    sv_two = os.path.join(work, "m_sv.sv.vcf.gz")
    walls["sv_2proc_2samples"], lines = _workers(
        ["sv", sv_two, "2", "{pid}", os.path.join(work, "ex_sv"), "smoke_sv"]
        + [f"{s.name}:{s.full}:{s.splitters}:{s.discordants}"
           for s in samples], "sv")
    worker_launches["sv"] = _worker_launches(lines)
    checks["sv_2proc"] = _vcf_text(sv_one) == _vcf_text(sv_two)
    check(all(w.get("sv_cluster", 0) > 0 for w in worker_launches["sv"]),
          "sv: a worker launched no sv_cluster kernel")

    emit({"phase": "multi", "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": smi,
          "cards_visible": torch.cuda.device_count(), "batch": BATCH,
          "align_pairs": MULTI_PAIRS, "genotype_sites": sites,
          "sv_calls": len(calls), "walls_s": walls, "checks": checks,
          "mesh_launches": mesh_launches,
          "worker_launches": worker_launches})
    for name, ok in checks.items():
        check(ok, f"multi: {name} differs from the single-device run")


def _sweep_pieces(cols):
    """Lengths of the pieces between the sweep's forced breaks (a gid
    change, or start1 at or past the largest end1 of the gid's earlier
    rows), from the packed keys' prefix max as the kernel finds them."""
    import numpy as np

    g, s1, e1 = (np.asarray(c, np.int64) for c in cols[:3])
    key = (g << 32) | ((e1 & 0xFFFFFFFF) ^ 0x80000000)
    prev = np.r_[np.iinfo(np.int64).min, np.maximum.accumulate(key)[:-1]]
    brk = ((prev >> 32) != g) | (s1 >= (prev & 0xFFFFFFFF) - 2**31)
    return np.diff(np.r_[np.flatnonzero(brk), len(g)])


def phase_sv_kernel(cols_main, args, clock_hz: float):
    """The sweep kernels against their twin at the sv phase's evidence, at
    1,048,576 rows in 16 groups (uniform, almost all singletons) and at
    1,048,576 rows in 256 skewed groups with piles of overlapping rows;
    returns the kernels-line record (at the sv phase's shape, the one the
    main path gives it).  The bound: the bytes, or the serial chain of
    the longest piece between forced breaks (the function's own serial
    work); the longest group's chain, the first design's figure, is
    reported beside it."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.ops import sv_cluster
    from speedseq_tpu_torch.utils import sv_cases

    rec = None
    for label, cols in (("sv_phase", cols_main),
                        ("genome", sv_cases.sweep_columns("genome",
                                                          seed=args.seed)),
                        ("genome-piles", sv_cases.sweep_columns(
                            "genome-piles", seed=args.seed))):
        host = [torch.from_numpy(c) for c in cols]
        dev = [c.cuda() for c in host]
        before = sv_cluster.LAUNCHES["sv_cluster"]
        got = sv_cluster.cluster_scan(*dev).cpu()
        torch.cuda.synchronize()
        check(sv_cluster.LAUNCHES["sv_cluster"] == before + 1,
              "sv_cluster did not launch")
        # the twin on the card's tensors at the main path's shape; on the
        # host at a genome's (a row step of small launches per row rank)
        twin_in = dev if label == "sv_phase" else host
        t0 = time.perf_counter()
        want = sv_cluster.cluster_scan_plain(*twin_in).cpu()
        plain_s = time.perf_counter() - t0
        max_err = int((got.long() - want.long()).abs().max())
        check(max_err == 0, f"sv_cluster disagrees with its twin ({label})")
        ms = cuda_ms(lambda: sv_cluster.cluster_scan(*dev), reps=20)
        device_ms = cuda_ms(lambda: sv_cluster.cluster_scan(*dev), reps=20,
                            queued=True)
        plain_ms = (cuda_ms(lambda: sv_cluster.cluster_scan_plain(*dev),
                            reps=2, warmup=1)
                    if label == "sv_phase" else None)
        n = len(cols[0])
        seg = np.diff(np.concatenate(
            [np.flatnonzero(np.r_[True, cols[0][1:] != cols[0][:-1]]), [n]]))
        pieces = _sweep_pieces(cols)
        nbytes = 4.0 * 6 * n               # five columns read, ids written
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per_row = sv_cluster.CHAIN_OPS_PER_ROW / clock_hz * 1e3
        chain_ms = int(pieces.max()) * per_row
        bound = max(bytes_ms, chain_ms)
        emit({"phase": "kernels", "kernel": "sv_cluster", "shape": label,
              "rows": n, "groups": int(len(seg)),
              "longest_group": int(seg.max()), "pieces": int(len(pieces)),
              "longest_piece": int(pieces.max()),
              "clusters": int(got[-1]) + 1, "bit_equal": True, "ms": ms,
              "device_ms": device_ms,
              "plain_ms": plain_ms, "plain_host_s": plain_s, "bytes": nbytes,
              "bytes_ms": bytes_ms, "chain_ms": chain_ms,
              "group_chain_ms": int(seg.max()) * per_row,
              "bound_ms": bound})
        if label == "sv_phase":
            rec = {"name": "sv_cluster", "route": "cuda",
                   "source": "speedseq_tpu_torch/ops/csrc/sv_cluster.cu",
                   "replaces": "speedseq_tpu/sv/device.py:74",
                   "launches": 0, "max_abs_err": max_err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "operations" if chain_ms >= bytes_ms
                   else "bytes", "library_ms": None}
    return rec


def _unbanded_bound(q, ql, r, clock_hz, n_sms):
    """The least time of the unbanded scan on these inputs: the rows it
    runs x Lr cells x ops/sw_unbanded.py:OPS_PER_CELL int32 instructions,
    or its bytes (query, qlen and window read, five outputs written)."""
    import numpy as np

    from speedseq_tpu_torch.ops import sw_unbanded

    q, ql, r = (a.cpu().numpy() if hasattr(a, "cpu") else a
                for a in (q, ql, r))
    n, Lq = q.shape
    rows = np.clip(ql.astype(np.int64), 0, Lq).sum()
    return _ops_bound(float(rows) * r.shape[1] * sw_unbanded.OPS_PER_CELL,
                      0, 4.0 * (q.size + ql.size + r.size + 5 * n), clock_hz,
                      n_sms)


def phase_unbanded_kernel(var_call, args, clock_hz, n_sms):
    """sw_unbanded_score against its twin on the card (bit-equal) on the
    inputs of the var run's largest haplotype-scan call, on
    utils/var_cases.hap_scan_lanes (150 x 192), on 250 bp reads (250 x
    320, unbanded_lanes) and, through the wide kernel, on 1,000 and 2,000
    bp reads (1000 x 1088, 2000 x 2112): wrapper ms, device ms (queue
    filled first), the twin's ms on the card, the bound.  Returns the
    kernels-line record (at the var call's shape, the one the main path
    gives it)."""
    import torch

    from speedseq_tpu_torch.ops import sw_unbanded
    from speedseq_tpu_torch.utils.var_cases import (hap_scan_lanes,
                                                    unbanded_lanes)

    kern, plain = sw_unbanded.sw_score_unbanded, \
        sw_unbanded.sw_score_unbanded_plain
    rec = None
    for label, host in (("var call", var_call),
                        ("hap_scan_lanes", hap_scan_lanes(args.seed)),
                        ("250 bp reads", unbanded_lanes(250, 320,
                                                        seed=args.seed)),
                        ("1,000 bp reads, wide", unbanded_lanes(
                            1000, 1088, seed=args.seed)),
                        ("2,000 bp reads, wide", unbanded_lanes(
                            2000, 2112, seed=args.seed))):
        q, ql, r = (torch.as_tensor(a).cuda() for a in host)
        before = sw_unbanded.LAUNCHES["sw_unbanded_score"]
        got = [t.cpu() for t in kern(q, ql, r)]
        torch.cuda.synchronize()
        check(sw_unbanded.LAUNCHES["sw_unbanded_score"] == before + 1,
              "sw_unbanded_score did not launch")
        want = [t.cpu() for t in plain(q, ql, r)]
        max_err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(got, want))
        check(max_err == 0, f"sw_unbanded_score disagrees with its twin "
              f"({label}: {max_err})")
        ms = cuda_ms(lambda: kern(q, ql, r), reps=20)
        device_ms = cuda_ms(lambda: kern(q, ql, r), reps=20, queued=True)
        plain_ms = cuda_ms(lambda: plain(q, ql, r), reps=3, warmup=1)
        bound = _unbanded_bound(q, ql, r, clock_hz, n_sms)
        emit({"phase": "kernels", "kernel": "sw_unbanded_score",
              "case": label, "lanes": q.shape[0], "Lq": q.shape[1],
              "Lr": r.shape[1], "bit_equal": True, "ms": ms,
              "device_ms": device_ms, "plain_ms": plain_ms, **bound})
        if label == "var call":
            rec = {"name": "sw_unbanded_score", "route": "cuda",
                   "source": "speedseq_tpu_torch/ops/csrc/sw_unbanded.cu",
                   "replaces": "speedseq_tpu/align/sw.py:221",
                   "launches": 0, "max_abs_err": max_err, "ms": ms,
                   "device_ms": device_ms, "plain_ms": plain_ms,
                   "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"], "library_ms": None,
                   "shape": [q.shape[0], q.shape[1], r.shape[1]]}
    return rec


def _combine_bound(first, sizes, lo, start, clen, curves, W, clock_hz,
                   n_sms):
    """The least time of the member log-sum on these inputs, the largest
    of: its logs (one MUFU op each, at the cells inside a member's curve)
    or its fp32 adds (members x W) over their rates; its bytes (the cells
    inside each member's curve, clipped to W, read once, as are the
    starts, lengths and the (C,) first/sizes/lo; the (C, W) sums
    written); and the chain of the largest cluster's adds, which the
    fixed order makes dependent (FADD_LATENCY clocks a member).  The
    padding of the (n, D) curves past a member's length is never read.
    ``bound_ms_before_chain`` is the figure without the chain (printed
    before this bound counted it)."""
    import numpy as np

    m, l, st, cl = (t.cpu().numpy().astype(np.int64)
                    for t in (sizes, lo, start, clen))
    n, C = curves.shape[0], len(l)
    # the rows of cluster c are first[c] .. first[c] + sizes[c] - 1; a
    # member's cells are the columns w in [0, W) with 0 <= w - off < clen
    off = st - l[np.repeat(np.arange(C), m)]
    logs = float(np.clip(np.minimum(W, off + cl) - np.maximum(off, 0), 0,
                         None).sum())
    adds = float(n) * W
    ms = {"logs": logs / (n_sms * MUFU_PER_SM) / clock_hz * 1e3,
          "adds": adds / (n_sms * FP32_PER_SM) / clock_hz * 1e3,
          "bytes": 4.0 * (logs + 2 * n + 3 * C + C * W)
          / HBM_BYTES_PER_S * 1e3,
          "chain": float(m.max() if C else 0) * FADD_LATENCY / clock_hz
          * 1e3}
    by = max(ms, key=ms.get)
    before = max(("logs", "adds", "bytes"), key=ms.get)
    return {"logs": logs, "fp32_adds": adds, "logs_ms": ms["logs"],
            "adds_ms": ms["adds"], "bytes_ms": ms["bytes"],
            "chain_ms": ms["chain"], "bound_ms": ms[by], "bound_by": by,
            "bound_ms_before_chain": ms[before],
            "bound_by_before_chain": before}


def _combine_wrapper_split(a, reps=200):
    """Host microseconds a call of each step of ``combine_logsum`` on the
    inputs ``a`` (perf_counter over ``reps`` calls, the queue drained
    before each step): the input checks, the dtype/contiguity tests, the
    output's allocation, the current-device query, the raw stream, one
    launch through ctypes, and the whole wrapper; beside them the stream
    object and the device context that 0b69706's wrapper took, and
    converting first and sizes to int32 (what it did with the int64 ones
    the sv run passes)."""
    import torch

    from speedseq_tpu_torch.ops import sv_combine

    first, sizes, lo, start, clen, curves, W = a
    C, lib = lo.shape[0], sv_combine._load()
    # the entry for the caller's first/sizes (int64 from bincount, or int32)
    launch = (lib.ssq_sv_combine_logsum_i64 if first.dtype == torch.int64
              else lib.ssq_sv_combine_logsum)
    acc = torch.empty((C, W), dtype=torch.float32, device=lo.device)
    ptrs = (first.data_ptr(), sizes.data_ptr(), lo.data_ptr(), C,
            start.data_ptr(), clen.data_ptr(), curves.data_ptr(),
            curves.shape[1], W, acc.data_ptr())
    raw = torch.cuda.current_stream().cuda_stream

    def device_context():
        with torch.cuda.device(lo.device):
            pass

    steps = {
        "check": lambda: sv_combine._check(*a),
        "dtype_tests": lambda: [t.dtype == torch.int32 and t.is_contiguous()
                                for t in a[:5]],
        "empty": lambda: torch.empty((C, W), dtype=torch.float32,
                                     device=lo.device),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
            lo.device.index),
        "current_stream_object": lambda: torch.cuda.current_stream(
            lo.device).cuda_stream,
        "device_context": device_context,
        "to_int32_first_sizes": lambda: (first.to(torch.int32).contiguous(),
                                         sizes.to(torch.int32).contiguous()),
        "ctypes_launch": lambda: launch(*ptrs, raw),
        "wrapper": lambda: sv_combine.combine_logsum(*a),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def _log_rows(first, sizes, lo, start, clen, curves, W):
    """The (n, W) member log rows and each row's cluster, materialised (the
    library yardstick's input)."""
    import torch

    from speedseq_tpu_torch.ops import sv_combine

    C, D = lo.shape[0], curves.shape[1]
    cid = torch.repeat_interleave(torch.arange(C, device=lo.device),
                                  sizes.long())
    col = torch.arange(W, dtype=torch.int32, device=lo.device)[None, :]
    rel = col - (start - lo[cid])[:, None]
    inside = (rel >= 0) & (rel < clen[:, None])
    vals = torch.gather(curves, 1, rel.clamp(0, D - 1).long())
    eps = torch.tensor(sv_combine.EPS, dtype=torch.float32,
                       device=lo.device)
    return cid, torch.where(inside, torch.log(torch.maximum(vals, eps)),
                            torch.log(eps))


def phase_combine_kernel(sv_calls, pile_calls, clock_hz, n_sms):
    """sv_combine_logsum against its twin on the card (bit-equal) on the
    inputs of the sv run's cluster pass (both sides) and of the SV_PILE
    pile (both sides): device ms, the twin's ms on the card, the bound
    (with the largest cluster's chain of adds), the wrapper's host time
    step by step, and the wrapper's ms in turns with the library
    yardstick, ``index_add_`` of the materialised (n, W) log rows into
    (C, W) (not order-equal: its sum order is the device's; the rows are
    made beforehand).  Returns the kernels-line record (the sv run's first
    side)."""
    import torch

    from speedseq_tpu_torch.ops import sv_combine

    kern, plain = sv_combine.combine_logsum, sv_combine.sv_combine_logsum_plain
    rec = None
    for label, calls in (("sv run", sv_calls), ("pile", pile_calls)):
        check(len(calls) == 2, f"{label}: {len(calls)} combination calls, "
              f"not one a side")
        for side, a in enumerate(calls):
            before = sv_combine.LAUNCHES["sv_combine_logsum"]
            got = kern(*a).cpu()
            torch.cuda.synchronize()
            check(sv_combine.LAUNCHES["sv_combine_logsum"] == before + 1,
                  "sv_combine_logsum did not launch")
            want = plain(*a).cpu()
            bit_equal = torch.equal(got.view(torch.int32),
                                    want.view(torch.int32))
            max_err = float((got - want).abs().max())
            check(bit_equal, f"sv_combine_logsum disagrees with its twin "
                  f"({label}, side {side + 1}: {max_err})")
            device_ms = cuda_ms(lambda: kern(*a), reps=20, queued=True)
            plain_ms = (cuda_ms(lambda: plain(*a), reps=3, warmup=1)
                        if label == "sv run" else
                        cuda_ms(lambda: plain(*a), reps=1, warmup=0))
            cid, rows = _log_rows(*a)
            C, W = a[2].shape[0], a[6]
            lib = lambda: torch.zeros((C, W), device="cuda").index_add_(
                0, cid, rows)
            # the wrapper and the yardstick in turns (both host-bound at
            # the sv run), 100 calls a turn; each the mean of its turns
            turns = {"ms": [], "library_ms": []}
            for key in ("ms", "library_ms", "library_ms", "ms"):
                turns[key].append(cuda_ms(
                    (lambda: kern(*a)) if key == "ms" else lib, reps=100))
            ms, library_ms = (sum(turns[k]) / 2 for k in ("ms", "library_ms"))
            lib_err = float((lib().cpu() - want).abs().max())
            bound = _combine_bound(*a, clock_hz, n_sms)
            emit({"phase": "kernels", "kernel": "sv_combine_logsum",
                  "case": label, "side": side + 1, "clusters": C,
                  "members": a[3].shape[0],
                  "largest_cluster": int(a[1].max()), "W": W,
                  "D": a[5].shape[1], "bit_equal": True, "ms": ms,
                  "device_ms": device_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, "turns": turns,
                  "library_max_abs_err": lib_err,
                  "wrapper_split_us": _combine_wrapper_split(a), **bound})
            del cid, rows
            if label == "sv run" and side == 0:
                # the chain is of fp32 adds: an operations bound
                rec = {"name": "sv_combine_logsum", "route": "cuda",
                       "source": "speedseq_tpu_torch/ops/csrc/sv_combine.cu",
                       "replaces": "speedseq_tpu/sv/device.py:120",
                       "launches": 0, "max_abs_err": max_err, "ms": ms,
                       "device_ms": device_ms, "plain_ms": plain_ms,
                       "bound_ms": bound["bound_ms"],
                       "bound_by": ("bytes" if bound["bound_by"] == "bytes"
                                    else "operations"),
                       "bound_by_detail": bound["bound_by"],
                       "chain_ms": bound["chain_ms"],
                       "library_ms": library_ms,
                       "library": "index_add_ of the (n, W) log rows, "
                       "not order-equal", "shape": [C, W]}
    return rec


def phase_sv_combine(args):
    """``cluster_and_combine`` at one cluster of SV_PILE members, on cuda
    (timed, after a warm-up at 64 members) and on cpu: the same integers,
    curves within atol 2e-5.  Returns the combination kernel's inputs of
    the cuda run, one a side, on the card."""
    import numpy as np
    import torch

    from speedseq_tpu_torch.ops import sv_combine
    from speedseq_tpu_torch.sv import device as sd
    from speedseq_tpu_torch.sv.cluster import evidence_columns
    from speedseq_tpu_torch.utils import sv_cases
    from speedseq_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(args.seed + 400)
    warm = evidence_columns(sv_cases.pile_evidence(rng, 64))[1:]
    sd.cluster_and_combine(*warm, 0.0, device="cuda")
    cols = evidence_columns(sv_cases.pile_evidence(rng, SV_PILE))[1:]
    out, pile_in = {}, []
    for dev in ("cuda", "cpu"):
        metrics.reset()
        torch.cuda.synchronize()
        sv_combine.reset_launches()
        spy = (_spying(sv_combine, "combine_logsum", lambda *a:
                       pile_in.append(a)) if dev == "cuda"
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with spy:
            out[dev] = sd.cluster_and_combine(*cols, 0.0, device=dev)
        out[dev + "_s"] = time.perf_counter() - t0
        out[dev + "_metrics"] = metrics.snapshot()
        out[dev + "_launches"] = sv_combine.LAUNCHES["sv_combine_logsum"]
    g, c = out["cuda"], out["cpu"]
    check(g.n_clusters == c.n_clusters == 1,
          f"pile of {SV_PILE} gave {g.n_clusters} clusters")
    same = all(np.array_equal(a[k], b[k]) for a, b in
               ((g.pos, c.pos), (g.ci, c.ci), (g.ci95, c.ci95), (g.nz, c.nz))
               for k in (0, 1))
    err = max(float(np.abs(g.prob[k] - c.prob[k]).max()) for k in (0, 1))
    emit({"phase": "combine", "members": SV_PILE,
          "cuda_launches": out["cuda_launches"],
          "cpu_launches": out["cpu_launches"],
          "cuda_s": out["cuda_s"], "cpu_s": out["cpu_s"],
          "cuda_metrics": out["cuda_metrics"],
          "cpu_metrics": out["cpu_metrics"], "ints_equal": same,
          "prob_max_abs_err": err})
    check(same and err <= 2e-5, "cluster_and_combine: cuda and cpu disagree "
          f"on the pile (ints equal {same}, prob err {err})")
    check(out["cuda_launches"] == 2 and out["cpu_launches"] == 0,
          "sv_combine_logsum: not one launch a side on cuda, none on cpu")
    return pile_in


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", nargs="+", metavar="DIR",
                    help="only time the fm_search.cu, sv_cluster.cu, "
                    "sw_banded.cu, sw_unbanded.cu and sv_combine.cu that "
                    "each DIR holds against this checkout's, in turns "
                    "(phase against)")
    ap.add_argument("--ablate", nargs="+", metavar="DIR",
                    help="with --against or alone: more such sources, "
                    "timed in turns but not held to the twins (a kernel "
                    "with a part cut out)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from concurrent.futures import ThreadPoolExecutor

    from speedseq_tpu_torch.ops import (fm_search, seed_chain, sv_cluster,
                                        sv_combine, sw_banded, sw_unbanded)
    from speedseq_tpu_torch.utils import synth

    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": props.multi_processor_count,
          "max_sm_clock_mhz": clock_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    mods = (sw_banded, sv_cluster, fm_search, sw_unbanded, sv_combine,
            seed_chain)
    with ThreadPoolExecutor(len(mods)) as pool:    # one nvcc per source
        list(pool.map(lambda m: m.build(verbose_ptxas=True), mods))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {m.__name__.rsplit(".", 1)[1]: {
              "seconds": m.BUILD_INFO.get("seconds"),
              "command": m.BUILD_INFO.get("command"),
              "ptxas": [l.strip() for l in
                        m.BUILD_INFO.get("ptxas", "").splitlines()
                        if "registers" in l or "spill" in l
                        or "Compiling" in l]} for m in mods}})

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if args.against or args.ablate:
        try:
            genome = synth.make_genome(GENOME, seed=args.seed, n_del=64)
            fasta = os.path.join(work, "genome.fa")
            synth.write_fasta(fasta, genome)
            phase_against(work, fasta, genome, args, args.against or [],
                          clock_mhz * 1e6, props.multi_processor_count)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    records = phase_kernels(args, clock_mhz * 1e6, props.multi_processor_count)
    try:
        genome = synth.make_genome(GENOME, seed=args.seed, n_del=64)
        fasta = os.path.join(work, "genome.fa")
        synth.write_fasta(fasta, genome)
        phase_parity(work, fasta, genome, args)
        records["seed_chain"] = phase_seed_chain(
            fasta, genome, args, clock_mhz * 1e6, props.multi_processor_count)
        records.update(phase_fm_kernels(work, fasta, genome, args,
                                        clock_mhz * 1e6,
                                        props.multi_processor_count))
        walk_launches = phase_parity(work, fasta, genome, args, "fm")
        launches = phase_align(work, fasta, genome, args)
        phase_cigar_batch(work, fasta, genome, args)
        fm_launches = phase_align(work, fasta, genome, args, "fm")
        records["sw_unbanded_cigar"], launches["sw_unbanded_cigar"] = \
            phase_unfused(work, fasta, genome, args, clock_mhz * 1e6,
                          props.multi_processor_count)
        launches["fm_smem"] = fm_launches["fm_smem"]
        launches["fm_sa_walk"] = walk_launches["fm_sa_walk"]
        phase_realign(work, fasta)
        launches["sw_unbanded_score"], var_call = phase_var(work, args)
        som_launches = phase_somatic(work, args)
        sv_launches, sv_cols, sv_calls = phase_sv(work, args)
        phase_multi(work, args, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    records["sv_cluster"] = phase_sv_kernel(sv_cols, args, clock_mhz * 1e6)
    launches.update(sv_launches)
    pile_calls = phase_sv_combine(args)
    records["sw_unbanded_score"] = phase_unbanded_kernel(
        var_call, args, clock_mhz * 1e6, props.multi_processor_count)
    records["sw_unbanded_score"]["launches_somatic"] = som_launches
    records["sv_combine_logsum"] = phase_combine_kernel(
        sv_calls, pile_calls, clock_mhz * 1e6, props.multi_processor_count)

    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
