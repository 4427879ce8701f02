"""The frozen kernel counts and the model-FLOP arithmetic against values
worked by hand."""
import pytest


def test_visible_pairs():
    from portbench.work import counts
    assert counts.visible_pairs(4, 4, True, 0) == 10
    assert counts.visible_pairs(4, 4, False, 0) == 16
    assert counts.visible_pairs(4, 4, True, 2) == 7
    assert counts.visible_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2


def test_flash_counts():
    from portbench.work import counts
    # B=1, S=4, H=2, KV=1, D=8, causal: 10 pairs a head, 20 in all
    fwd = counts.flash_attention_work((1, 4, 2, 8), (1, 4, 1, 8), True)
    assert fwd["matmul_flops"] == 4 * 20 * 8
    assert fwd["flops"] == 4 * 20 * 8 + 4 * 20 + 1 * 4 * 2 * 8
    assert fwd["bytes_accessed"] == 4 * 2 * (4 * 2 * 8 + 4 * 1 * 8)
    dq = counts.flash_attention_bwd_dq_work((1, 4, 2, 8), (1, 4, 1, 8), True)
    dkdv = counts.flash_attention_bwd_dkdv_work((1, 4, 2, 8), (1, 4, 1, 8),
                                                True)
    assert dq["matmul_flops"] == dkdv["matmul_flops"] == 4 * 20 * 8


def test_ssd_counts():
    from portbench.work import counts
    # one chunk of q = 4 rows: t = 10 causal pairs; B=1, H=2, P=3, N=5
    prod, elem, trans = counts.ssd_terms((1, 4, 2, 3), 5, 4)
    assert prod == 2 * 10 * 5 + 2 * (2 * 10 * 3 + 4 * 4 * 5 * 3)
    assert elem == 2 * (2 * 10 + 4 * 4 + 4 * 3 + 2 * 3 * 5)
    assert trans == 2 * (10 + 2 * 4 + 1)
    fwd = counts.ssd_scan_work((1, 4, 2, 3), (1, 4, 5), chunk=4)
    bwd = counts.ssd_scan_bwd_work((1, 4, 2, 3), (1, 4, 5), chunk=4)
    assert fwd["matmul_flops"] == prod
    assert bwd["matmul_flops"] == 2 * prod


def _cfg(name):
    import json
    from conftest import ROOT
    return json.loads((ROOT / "portbench/configs" / f"{name}.json")
                      .read_text())["port"]


def test_matmul_params():
    from portbench import registry
    dense = registry.family("dense")
    ssm = registry.family("ssm")
    # qwen3-0.6b: 28 x (1024 x 2048 x 2 + 1024 x 1024 x 2 + 3 x 1024 x
    # 3072) + the tied unembedding 1024 x 151936
    assert dense.matmul_params(_cfg("qwen3-0.6b")) == \
        28 * 15_728_640 + 155_582_464 == 595_984_384
    # mamba2-780m: 48 x (1536 x 6448 + 3072 x 1536) + 1536 x 50280
    assert ssm.matmul_params(_cfg("mamba2-780m")) == \
        48 * (9_904_128 + 4_718_592) + 77_230_080 == 779_120_640


def test_round_model_flops_by_hand():
    from portbench import registry
    from portbench.work import roofline
    cfg = {"family": "dense", "num_layers": 1, "d_model": 8,
           "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
           "vocab_size": 10, "tie_embeddings": True}
    traffic = {"clients": 2, "local_steps": 3, "rows_per_step": 1,
               "seq": 4, "test_rows": 2}
    n = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16 + 8 * 10
    attn_fwd = 4 * (2 * 10) * 4          # 2 heads x 10 pairs x 4 D
    want = 6 * (6 * n * 4 + 3 * attn_fwd) \
        + 2 * n * 2 * 4 + 2 * attn_fwd
    got = roofline.round_model_flops(registry.family("dense"), cfg, traffic)
    assert got == want


def test_bound_is_the_largest_term():
    from portbench import registry
    from portbench.work import roofline
    peaks = registry.peaks()
    w = {"flops": 1e12, "matmul_flops": 1e12, "bytes_accessed": 0.0,
         "transcendentals": 0.0}
    assert roofline.bound_s(w, peaks) == pytest.approx(3e12 / 495e12)
    w = {"flops": 1e9, "matmul_flops": 0.0, "bytes_accessed": 3.35e12,
         "transcendentals": 0.0}
    assert roofline.bound_s(w, peaks) == pytest.approx(1.0)


def test_step_mfu_over_the_busy_time():
    from types import SimpleNamespace
    from portbench import registry
    from portbench.trace import Trace
    from portbench.work import roofline
    cfg = {"family": "dense", "num_layers": 1, "d_model": 8,
           "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
           "vocab_size": 10, "tie_embeddings": True}
    traffic = {"clients": 2, "local_steps": 3, "rows_per_step": 1,
               "seq": 4, "test_rows": 2}
    fam = registry.family("dense")
    # two traced rounds over 10 s, the device busy for 2 s of them in two
    # overlapping kernels (1-2 s and 1.5-3 s) and 6-6.5 s in a third
    s = 10 ** 9
    tr = Trace(0, 10 * s, [("a", s, 2 * s), ("b", 3 * s // 2, 3 * s),
                           ("c", 6 * s, 13 * s // 2)], [], 2)
    assert tr.busy_s == pytest.approx(2.5)
    cell = SimpleNamespace(config={"port": cfg}, traffic=traffic)
    reading = SimpleNamespace(trace=tr, peaks=registry.peaks(), family=fam,
                              cell=cell)
    want = 100 * 2 * roofline.round_model_flops(fam, cfg, traffic) \
        / (2.5 * 495e12 / 3)
    assert roofline.step_mfu(reading) == pytest.approx(want)
    reading.trace = Trace(0, 10 * s, [], [], 2)
    assert roofline.step_mfu(reading) is None
    reading.trace = None
    assert roofline.step_mfu(reading) is None
