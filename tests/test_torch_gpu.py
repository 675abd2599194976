"""The port's CUDA kernels against their plain twins, and var's two torch
programs on cuda against cpu, on the card (marked ``gpu``; they skip
without a CUDA device and count as not run).  Run on a
machine with a card (the conftest imports jax, so leave it out there):
python -m pytest --noconftest -m gpu tests/test_torch_gpu.py"""

import numpy as np
import pytest
import torch

from speedseq_tpu_torch.ops import sw_banded
from speedseq_tpu_torch.utils.sw_cases import sw_edge_cases

pytestmark = pytest.mark.gpu


def _need_card():
    # decided inside the test, so every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")


@pytest.mark.parametrize("n,Lq,params", [
    (4096, 151, (1, 4, 6, 1)), (1000, 112, (1, 4, 1, 1)), (3, 151, (1, 4, 6, 1))])
def test_cigar_kernel_matches_twin(n, Lq, params):
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_edge_cases(n, Lq, 256, seed=n))
    before = sw_banded.LAUNCHES["sw_cigar"]
    got = sw_banded.sw_cigar(q, ql, r, params)
    torch.cuda.synchronize()
    assert sw_banded.LAUNCHES["sw_cigar"] > before
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


def test_cigar_kernel_chunks_lanes(monkeypatch):
    """Past CHUNK_LANES the launch is split; results do not change."""
    _need_card()
    q, ql, r = (torch.from_numpy(a).cuda()
                for a in sw_edge_cases(300, 151, 256, seed=7))
    whole = sw_banded.sw_cigar(q, ql, r)
    monkeypatch.setattr(sw_banded, "CHUNK_LANES", 64)
    before = sw_banded.LAUNCHES["sw_cigar"]
    parts = sw_banded.sw_cigar(q, ql, r)
    assert sw_banded.LAUNCHES["sw_cigar"] - before == 5
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


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
