"""The port's fused eval statistics against the JAX package: the Pallas
kernel (interpret mode, as tests/test_pallas.py runs it) and the lax path.

Bars: counts exact; bin mean confidence and ECE at rtol 1e-4 / atol 1e-6
(the JAX kernel sums in float32); correction floats at rtol 1e-5. The CUDA
kernel against this plain path is tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rcu_tpu.eval import kernels as lax_kernels
from rcu_tpu.ops import calibration as jax_calibration
from rcu_tpu.ops.pallas import evalstats as jax_evalstats
from rcu_tpu_torch.ops import calibration
from rcu_tpu_torch.ops.cuda import evalstats
import sass_loop
from tests.test_torch_cuda import EDGES, THRESHOLDS, make_subject, port_inputs

COUNT_KEYS = ("tpu", "tnu", "fpu", "fnu", "tp", "tn", "fp", "fn")


def jax_pallas(fg, target, prediction, unc, mask):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return jax_evalstats.fused_subject_eval(
        f32(fg), f32(target), f32(prediction), f32(unc),
        None if mask is None else f32(mask), THRESHOLDS, interpret=True)


def assert_bins_close(bins, want_bins):
    np.testing.assert_array_equal(
        bins["bins_count"].numpy(),
        np.asarray(want_bins["bins_count"]).astype(np.int64))
    np.testing.assert_array_equal(bins["bins_non_zero"].numpy(),
                                  np.asarray(want_bins["bins_non_zero"]))
    for key in ("bins_avg_confidence", "bins_positive_fraction"):
        np.testing.assert_allclose(bins[key].numpy(), np.asarray(want_bins[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(bins["ece"]), float(want_bins["ece"]),
                               rtol=1e-4, atol=1e-6)


def assert_correction_close(correction, want):
    for key in want:
        got = correction[key].numpy()
        ref = np.asarray(want[key])
        if key in COUNT_KEYS:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          ref.astype(np.int64), err_msg=key)
        elif ref.dtype == np.bool_:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("shape,masked", [((5, 41, 39), True),
                                          ((5, 41, 39), False),
                                          ((3, 17, 19), True)])
def test_reference_sums_match_pallas(shape, masked):
    fg, target, prediction, unc, mask = make_subject(1, shape, masked)
    weight = mask if masked else np.ones(shape, bool)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    want = jax_evalstats.fused_eval_stats(
        f32(fg), f32(target), f32(prediction), f32(unc), f32(weight),
        THRESHOLDS, interpret=True)
    got = evalstats.fused_eval_stats_reference(
        *port_inputs(fg, target, prediction, unc, weight)[:4],
        torch.from_numpy(weight.astype(np.uint8)), THRESHOLDS)
    for key in ("bins_count", "bins_true_sum", "thresh_counts"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]).astype(np.int64),
                                      err_msg=key)
    for key in ("tp", "tn", "fp", "fn"):
        assert int(got[key]) == int(want[key]), key
    np.testing.assert_allclose(got["bins_conf_sum"].numpy(),
                               np.asarray(want["bins_conf_sum"]), rtol=1e-4)


@pytest.mark.parametrize("masked", [True, False])
def test_subject_eval_matches_pallas_and_lax(masked):
    fg, target, prediction, unc, mask = make_subject(2, (5, 41, 39), masked)
    bins, confusion, correction = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    want_bins, want_conf, want_corr = jax_pallas(fg, target, prediction, unc,
                                                 mask)
    assert_bins_close(bins, want_bins)
    for key in ("tp", "tn", "fp", "fn", "n"):
        assert int(confusion[key]) == int(want_conf[key]), key
    np.testing.assert_allclose(float(confusion["dice"]),
                               float(want_conf["dice"]), rtol=1e-5)
    assert_correction_close(correction, want_corr)

    lax_bins = lax_kernels.calibration_bins(
        jnp.asarray(fg), jnp.asarray(target, jnp.float32),
        jnp.asarray(prediction), None if mask is None else jnp.asarray(mask))
    assert_bins_close(bins, lax_bins)
    lax_corr = lax_kernels.correction_eval(
        jnp.asarray(prediction), jnp.asarray(target), jnp.asarray(unc),
        jnp.asarray(THRESHOLDS, jnp.float32))
    assert_correction_close(correction, lax_corr)


def test_all_masked_out_gives_nan_ece():
    fg, target, prediction, unc, _ = make_subject(3, (2, 9, 11))
    mask = np.zeros(fg.shape, bool)
    bins, confusion, _ = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    want_bins, _, _ = jax_pallas(fg, target, prediction, unc, mask)
    assert np.isnan(float(bins["ece"])) and np.isnan(float(want_bins["ece"]))
    assert int(bins["bins_count"].sum()) == 0
    assert int(confusion["n"]) == fg.size  # the mask reaches the bins only


def test_cpu_tensors_take_the_plain_version():
    inputs = port_inputs(*make_subject(4, (2, 5, 7)))
    launches, plain = evalstats.fused_eval_stats.launches, \
        evalstats.fused_eval_stats.plain_calls
    evalstats.fused_subject_eval(*inputs, THRESHOLDS)
    assert evalstats.fused_eval_stats.plain_calls == plain + 1
    assert evalstats.fused_eval_stats.launches == launches
    with pytest.raises(ValueError, match="at most 23"):
        evalstats.fused_eval_stats(*inputs[:4], inputs[1], (0.5,) * 24)


SHAPES = [(1, 1, 7), (2, 13, 11), (4, 16, 16)]


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.integers(0, len(SHAPES) - 1), st.integers(0, 2 ** 31 - 1),
       st.booleans(), st.floats(0.0, 1.0), st.floats(0.0, 1.0))
def test_fuzz_against_lax(shape_index, seed, masked, target_rate, edge_rate):
    """Random contents at a few fixed shapes (the jitted lax path compiles
    once per shape): bin-edge salting, any target rate, mask or none."""
    shape = SHAPES[shape_index]
    rng = np.random.RandomState(seed)
    fg = rng.rand(*shape).astype(np.float32)
    salted = rng.rand(*shape) < edge_rate
    fg[salted] = rng.choice(EDGES, int(salted.sum()))
    target = rng.rand(*shape) < target_rate
    prediction = fg > 0.5
    unc = rng.rand(*shape).astype(np.float32)
    salted = rng.rand(*shape) < edge_rate
    unc[salted] = rng.choice(np.float32(THRESHOLDS), int(salted.sum()))
    mask = rng.rand(*shape) < 0.7 if masked else None
    bins, confusion, correction = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    lax_bins = lax_kernels.calibration_bins(
        jnp.asarray(fg), jnp.asarray(target, jnp.float32),
        jnp.asarray(prediction), None if mask is None else jnp.asarray(mask))
    if np.isnan(float(lax_bins["ece"])):
        assert np.isnan(float(bins["ece"]))
        assert int(bins["bins_count"].sum()) == 0
    else:
        assert_bins_close(bins, lax_bins)
    assert_correction_close(correction, lax_kernels.correction_eval(
        jnp.asarray(prediction), jnp.asarray(target), jnp.asarray(unc),
        jnp.asarray(THRESHOLDS, jnp.float32)))
    p, t = prediction, target
    assert int(confusion["tn"]) == int(np.sum(~p & ~t))


# host logic of the CUDA kernel (rcu_tpu_torch/csrc/evalstats.cu), which
# the CPU reaches as plain functions of the wrapper module
NAN, INF = float("nan"), float("inf")
THRESHOLD_SETS = [THRESHOLDS, THRESHOLDS[::-1], (0.5, 0.1, 0.9, 0.1, 0.3, 0.3),
                  (0.3, NAN, 0.1, INF, -INF, 0.0), (0.7,), (),
                  tuple(np.linspace(0.0, 1.0, 23))]


def salted_planes(seed, n, thresholds):
    """fg salted with every bin edge, its neighbours, NaN and +-inf; u with
    every threshold, its neighbours, NaN and +-inf."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(n).astype(np.float32)
    unc = rng.rand(n).astype(np.float32)
    special = np.float32([NAN, INF, -INF, 0.0, -0.0, 1.0])
    edges = np.concatenate([EDGES, np.nextafter(EDGES, np.float32(2)),
                            np.nextafter(EDGES, np.float32(-1)), special])
    th = np.float32([t for t in thresholds if np.isfinite(t)])
    levels = np.concatenate([th, np.nextafter(th, np.float32(2)),
                             np.nextafter(th, np.float32(-1)), special])
    fg[rng.choice(n, edges.size, replace=False)] = edges
    unc[rng.choice(n, levels.size, replace=False)] = levels
    target = rng.rand(n) < 0.3
    weight = rng.rand(n) < 0.8
    return fg, target, fg > 0.5, unc, weight


def test_kernel_edges_give_the_bin_ids():
    fg = salted_planes(11, 4000, THRESHOLDS)[0]
    edges = evalstats.kernel_edges()
    assert edges.dtype == np.float32 and edges.shape == (9,)
    ids = (fg[:, None] >= edges[None, :]).sum(1)
    np.testing.assert_array_equal(
        ids, calibration.bin_ids(torch.from_numpy(fg)).numpy())
    np.testing.assert_array_equal(  # the JAX package's bin ids
        ids[np.isfinite(fg)], np.asarray(jax_calibration.bin_ids(
            jnp.asarray(fg[np.isfinite(fg)]), 10)))


@pytest.mark.parametrize("thresholds", THRESHOLD_SETS)
def test_sorted_thresholds_go_back_to_the_callers_order(thresholds):
    th, order = evalstats.sort_thresholds(thresholds)
    assert th.dtype == np.float32 and th.shape == (len(thresholds),)
    assert np.all(th[:-1] <= th[1:]) and not np.isnan(th).any()
    assert sorted(order.tolist()) == list(range(len(thresholds)))
    want = np.float32(thresholds).reshape(-1)
    want = np.where(np.isnan(want), np.float32(INF), want)
    np.testing.assert_array_equal(th, want[order])


@pytest.mark.parametrize("thresholds", THRESHOLD_SETS)
def test_histogram_suffix_sums_equal_the_reference(thresholds):
    """The (class, m) histogram, summed as the kernel's last block sums it,
    gives the plain version's confusion and threshold counts."""
    fg, target, prediction, unc, weight = salted_planes(12, 5003, thresholds)
    th, order = evalstats.sort_thresholds(thresholds)
    m = (unc[:, None] > th[None, :]).sum(1)
    c = 2 * target.astype(int) + prediction.astype(int)
    hist = np.zeros((4, th.size + 1), np.int64)
    np.add.at(hist, (c, m), 1)
    confusion, rows = evalstats.counts_from_histogram(hist)
    placed = np.empty_like(rows)
    placed[order] = rows  # the kernel writes sorted row j to row order[j]
    want = evalstats.fused_eval_stats_reference(
        *port_inputs(fg, target, prediction, unc, weight), thresholds)
    assert confusion.tolist() == [int(want[k]) for k in ("tp", "tn", "fp", "fn")]
    np.testing.assert_array_equal(placed, want["thresh_counts"].numpy())


@pytest.mark.parametrize("n,grid,lane", [
    (0, 1, 0), (7, 1, 8), (8_928_000, 264, 136), (8_928_000, 1, 34_880),
    (2 ** 39 - 16 * 256, 1, 2 ** 31 - 16), (2 ** 39, 1, 2 ** 31),
    (2 ** 40, 132, 32_537_632)])
def test_lane_counts_stay_within_int32(n, grid, lane):
    assert evalstats.lane_voxels(n, grid) == lane
    if lane >= 2 ** 31:
        with pytest.raises(ValueError, match="int32"):
            evalstats.check_lane_counts(n, grid)
    else:
        evalstats.check_lane_counts(n, grid)


@pytest.mark.parametrize("n,wave,grid", [(0, 264, 1), (7, 264, 1),
                                         (2048, 264, 1), (2049, 264, 2),
                                         (8_928_000, 264, 264),
                                         (1_000_003, 132, 132)])
def test_grid_is_one_wave_at_most(n, wave, grid):
    assert evalstats.grid_size(n, wave) == grid


@pytest.mark.parametrize("thresholds", THRESHOLD_SETS)
def test_threshold_arguments_are_cached_once_per_key(thresholds):
    """Equal thresholds share one cache entry, NaN objects that compare
    unequal included; the cached arguments are the sorted thresholds and
    the caller's row of each."""
    evalstats._host_args.cache_clear()
    copies = [tuple(float("nan") if np.isnan(x) else float(x)
                    for x in thresholds) for _ in range(3)]
    args = [evalstats._host_args(evalstats.host_args_key(c)) for c in copies]
    assert evalstats._host_args.cache_info().currsize == 1
    assert all(a is args[0] for a in args)
    edge, th_arg, slots, n = args[0]
    th, order = evalstats.sort_thresholds(thresholds)
    assert n == len(thresholds)
    np.testing.assert_array_equal(np.float32(th_arg[:n]), th)
    assert list(slots[:n]) == order.tolist()
    np.testing.assert_array_equal(np.float32(edge[:]), evalstats.kernel_edges())


@pytest.mark.parametrize("n_thresholds,cells", [(0, 34), (11, 78), (23, 126)])
def test_a_lanes_cells_follow_the_threshold_count(n_thresholds, cells):
    assert evalstats.lane_cells(n_thresholds) == cells


SASS = """
        Function : _Z6kernelPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FSETP.GE.AND P0, PT, R2, R3, PT ;
.L_x_1:
        /*0030*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0040*/                   LDS R5, [R6] ;
        /*0050*/                   IADD3 R5, R5, R7, RZ ;
        /*0060*/                   STS [R6], R5 ;
        /*0070*/               @P0 BRA `(.L_x_1) ;
        /*0080*/                   ISETP.GE.AND P1, PT, R4, R8, PT ;
        /*0090*/              @!P1 BRA 0x30 ;
        /*00a0*/                   EXIT ;
"""
# part of the loop placed after the function's exit, as nvcc does for a
# branch taken rarely; the exit and the store before it are not in it
SASS_OUT_OF_LINE = """
        Function : _Z6kernelPf
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_2:
        /*0010*/                   LDG.E R5, desc[UR4][R2.64] ;
        /*0020*/               @P0 BRA `(.L_x_3) ;
        /*0030*/                   IADD3 R4, R4, 0x1, RZ ;
.L_x_4:
        /*0040*/                   ISETP.GE.AND P1, PT, R4, R8, PT ;
        /*0050*/              @!P1 BRA `(.L_x_2) ;
        /*0060*/                   STS [R6], R5 ;
        /*0070*/                   EXIT ;
.L_x_3:
        /*0080*/                   IADD3 R4, R4, 0x2, RZ ;
        /*0090*/                   BRA `(.L_x_4) ;
"""
# a branch back that is no loop: cold code after the exit rejoins the main
# line; and the self-branch that pads the end of every function
SASS_NO_LOOP = """
        Function : _Z6kernelPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P0 BRA `(.L_x_5) ;
.L_x_6:
        /*0020*/                   STS [R6], R5 ;
        /*0030*/                   EXIT ;
.L_x_5:
        /*0040*/                   IADD3 R4, R4, 0x2, RZ ;
        /*0050*/                   BRA `(.L_x_6) ;
.L_x_7:
        /*0060*/                   BRA `(.L_x_7) ;
"""


@pytest.mark.parametrize("text,addresses,ops", [
    (SASS, list(range(0x30, 0xa0, 0x10)), ["IADD3", "LDS"]),
    (SASS_OUT_OF_LINE, [0x10, 0x20, 0x30, 0x40, 0x50, 0x80, 0x90],
     ["LDG.E", "BRA"]),
    (SASS_NO_LOOP, [0x60], ["BRA"])])
def test_sass_loop_count(text, addresses, ops):
    functions = sass_loop.parse(text)
    assert list(functions) == ["_Z6kernelPf"]
    loop = sass_loop.largest_loop(functions["_Z6kernelPf"])
    assert [x[0] for x in loop] == addresses
    assert [x[1] for x in loop][:2] == ops
