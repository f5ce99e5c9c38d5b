"""The metric readers on a recorded run: device operations, stage regions
and counters written out by hand."""

import pytest

from perfbench import devtrace, harness
from perfbench.peaks import bound_s

SUB = "void (anonymous namespace)::sub_matmul_kernel_f64_dmma<64>(int, int)"
GEMV = "void gemv2T_kernel_val<int, int, double>(double const*)"


def record(root, ops, launches, stages=None, walls=(1.0, 1.0), n=200):
    spec = harness.load_cell("eigen_s-f64-n8192.A-random", root)
    spec["config"].update(n=n, panel_forward=64, panel_backward=128)
    return {"config": spec["config"],
            "traffic": spec["traffic"], "n": n,
            "dtype": "float64", "setup_s": 12.5,
            "window_s": sum(walls), "walls": list(walls),
            "solves": len(walls), "stages": stages or [{} for _ in walls],
            "peak_bytes": 3 * 2 ** 30, "ops": ops,
            "launches": {"sub_matmul": launches}, "profiled_wall_s": 1.5}


def metric(root, name, rec):
    return harness.reader(root / "perfbench" / "metrics", name)(rec)


# n=200, panels of 64: 3 trailing updates (136², 72², 8²) and 2 WY blocks
SHAPES = [(136, 136, 128), (72, 72, 128), (8, 8, 128),
          (72, 200, 71), (200, 200, 128)]
OPS = [(GEMV, 0.00, 0.10), ("Memcpy DtoD (Device -> Device)", 0.10, 0.15),
       (SUB, 0.30, 0.40), (GEMV, 0.35, 0.45), (SUB, 0.50, 0.60),
       (SUB, 0.70, 0.71), (SUB, 0.80, 0.85), (SUB, 0.90, 1.00)]


def test_launch_shapes(root):
    from importlib import util
    path = root / "perfbench" / "metrics" / "sub_matmul_roofline.py"
    spec = util.spec_from_file_location("sm", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.launch_shapes(record(root, OPS, 5)) == SHAPES


def test_roofline_share(root):
    rec = record(root, OPS, 5)
    want = sum(bound_s("float64", 2 * m * c + (m + c) * k, 2 * m * c * k)
               for m, c, k in SHAPES) / 0.36
    assert metric(root, "sub_matmul_roofline", rec) == pytest.approx(
        100 * want)


def test_roofline_fails_on_other_launch_counts(root):
    with pytest.raises(RuntimeError, match="5 launches enumerated"):
        metric(root, "sub_matmul_roofline", record(root, OPS, 4))


def test_device_readers(root):
    rec = record(root, OPS, 5)
    assert devtrace.busy_s(OPS) == pytest.approx(0.10 + 0.05 + 0.15 + 0.10
                                                 + 0.01 + 0.05 + 0.10)
    assert metric(root, "kernels_per_solve", rec) == 7
    assert metric(root, "device_idle", rec) == pytest.approx(
        100 * (1 - 0.56 / 1.0))
    b = devtrace.breakdown(OPS)
    assert b["device_ops"][0] == ["sub_matmul_kernel_f64_dmma<64>",
                                  pytest.approx(0.36)]
    sub = "sub_matmul_kernel_f64_dmma<64>"
    assert b["idle_gaps"] == [
        [f"{sub} -> {sub} x3", pytest.approx(0.24)],
        [f"Memcpy DtoD (Device -> Device) -> {sub} x1", pytest.approx(0.15)],
        [f"gemv2T_kernel_val<int, int, double> -> {sub} x1",
         pytest.approx(0.05)]]


@pytest.mark.parametrize("name", ["sub_matmul_roofline", "kernels_per_solve",
                                  "device_idle"])
def test_nothing_to_read_gives_nothing(root, name):
    assert metric(root, name, record(root, [], 0)) is None


def test_stage_readers(root):
    st = [{"TRD-BLK": {"seconds": 3.0}, "D&C": {"seconds": 0.5},
           "TRDBAK": {"seconds": 0.1}},
          {"TRD-BLK": {"seconds": 4.0}, "D&C": {"seconds": 0.7},
           "TRDBAK": {"seconds": 0.1}}]
    rec = record(root, [], 0, stages=st)
    assert metric(root, "trd_blk_s", rec) == pytest.approx(3.5)
    assert metric(root, "dc_tree_s", rec) == pytest.approx(0.6)
    assert metric(root, "trdbak_s", rec) == pytest.approx(0.1)
    rec["stages"] = [st[0], {}]                         # not every solve
    assert metric(root, "trd_blk_s", rec) is None


def test_end_to_end_readers(root):
    rec = record(root, [], 0, walls=(2.0, 3.0, 4.0))
    assert metric(root, "solve_s", rec) == pytest.approx(3.0)
    assert metric(root, "setup_s", rec) == 12.5
    assert metric(root, "peak_mem_gib", rec) == 3.0


@pytest.mark.parametrize("raw,short", [
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
     "double>(cublasGemvParamsEx<int>)", "internal::gemvx::kernel<int, double>"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "CUDAFunctor_add<double>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<double>)",
     "vectorized_elementwise_kernel<2, CUDAFunctor_add<double>, array<char*, "
     "3ul> >"[:72]),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize32x32x32_stage5_warpsize2x"
     "2x1_tensor16x8x16_execute_split_k_kernel__5x_cublas",
     "sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize32x32x32_stage5_warpsize2x"[
         :72])])
def test_short_names(raw, short):
    assert devtrace.short_name(raw) == short
