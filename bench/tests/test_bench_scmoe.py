"""The ScMoE layer kind on the CPU: its plain reference against the port's
(``models/longcat_ref.py``) and the port's plain path at a tiny size, its
control's precision, and its counts worked out by hand for the cell's
shapes."""
import pytest
import torch

from bench.counts import peaks, scmoe as counts
from bench.layers import scmoe as layer_kind
from bench.reference import common, scmoe as ref

TINY = {"hidden_size": 64, "expert_ffn_hidden_size": 64,
        "ffn_hidden_size": 128, "n_routed_experts": 16,
        "zero_expert_num": 8, "moe_topk": 6, "num_layers": 3,
        "experts_held": 8, "routed_scaling_factor": 6,
        "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
MIX = {"entry": "scmoe_step", "directive": {
    "backend": "PALLAS_RDMA", "completion": "COUNTER",
    "placement": "TILE_FUSED", "scope": "LOCAL", "issuer": "GRID_STEP",
    "granularity": "PER_TILE", "ordering": "ACQREL", "contexts": 2,
    "tunables": {"tight": 1}}}


def _layer(seed=2**31 + 3):
    return layer_kind.Layer(TINY, MIX, [{"tokens_per_rank": 16}] * 2, seed,
                            "cpu")


def test_reference_is_the_ports_reference():
    from repro_torch.models import longcat_ref
    lay = _layer()
    cfg = lay.cfg
    h = lay.h[0]
    want, picks, gap = longcat_ref.forward(h, lay.layers, **cfg)
    got, got_picks, got_gap = ref.forward(h, lay.layers, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(picks, got_picks))
    assert gap == got_gap == 0.0
    assert common.row_rel_err(got, want) < 1e-6


def test_a_step_of_the_ports_plain_path_checks_out():
    lay = _layer()
    assert lay.launches(0) == 3 and lay.tokens(0) == 8 * 16
    out = lay.steps[1]()
    got, picks = out
    assert len(picks) == 3 and picks[0].shape == (8, 16, 6)
    nums = lay.check(1, out)
    assert nums["route_gap"] == 0.0 and nums["row_rel_err"] < 1e-6
    # the FFN rows are the reference's own routing's
    assert lay.rows(1) == tuple(int((p < 16).sum()) for p in picks)


def test_control_reads_far_above_the_float32_reference():
    lay = _layer()
    h = lay.h[0]
    want = ref.forward(h, lay.layers, **lay.cfg)[0]
    ctrl = ref.forward(h, lay.layers, mode="tf32", **lay.cfg)[0]
    assert common.row_rel_err(ctrl, want) > 1e-4


def test_counts_of_the_cell():
    # a layer of 8192 FFN rows, 1024 tokens: 8192 x 6 x 6144 x 2048 routed,
    # 2 x 1024 x 6 x 6144 x 12288 dense, 2 x 1024 x 6144 x 768 router
    N, d, f, fd = 1024, 6144, 2048, 12288
    routed = 8192 * 6 * d * f
    assert routed == 618_475_290_624
    dense = 2 * N * 6 * d * fd
    router = 2 * N * d * 768
    assert counts.flops([8192] * 4, N, d, f, fd, 768) \
        == 4 * (routed + dense + router)
    assert counts.flops([8192] * 4, N, d, f, fd, 768) == pytest.approx(
        6.22e12, rel=1e-3)
    assert counts.kernel_flops([8192] * 4, N, d, f, fd) \
        == 4 * (routed + dense // 2)
    # the kernel: 8 expert tensors and FFN1's weights read once, the
    # routed rows and FFN1's tokens in and out once
    weights = 8 * 3 * d * f + 3 * d * fd
    assert counts.kernel_nbytes([8192], N, d, f, fd, 8) == 4 * (
        weights + 2 * 8192 * d + 2 * N * d)
    assert counts.nbytes([8192], N, d, f, fd, 768, 8) == 4 * (
        2 * N * d + 8 * 3 * d * f + 6 * d * fd + (d + 1) * 768 + 2 * d)
    # operations bound the kernel: over 5 ms a layer at the TF32 peak
    kb = peaks.bound_s(counts.kernel_flops([8192], N, d, f, fd),
                       counts.kernel_nbytes([8192], N, d, f, fd, 8),
                       "float32")
    assert kb == pytest.approx((routed + dense // 2) / 495e12)
