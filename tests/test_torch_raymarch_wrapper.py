"""The ray-march kernel's wrapper, as far as it runs without a GPU: the
thread-to-ray map of the kernel's 8x4 pixel tiles (``tile_ray_index``, the
numpy twin of ``ray_of_thread`` in ``csrc/raymarch.cu``), the build-flag
variants, the ptxas report, and the work counts of ``chip_smoke.py`` that
rest on the map."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from test_torch_import import _small_state

torch.set_num_threads(1)

# Widths and heights that are and are not multiples of the 8x4 tile.
IMAGES = [(16, 8), (13, 7), (8, 4), (7, 3), (1, 1), (33, 2), (5, 64),
          (480, 270)]


@pytest.mark.parametrize("width,height", IMAGES)
def test_tile_map_is_a_permutation(width, height):
    n = width * height
    idx = raymarch.tile_ray_index(n, width)
    assert idx.size % 32 == 0
    assert idx.min() >= -1
    np.testing.assert_array_equal(np.sort(idx[idx >= 0]), np.arange(n))
    # Threads without a ray are only those beyond the right or bottom edge.
    tiles = -(-width // 8) * -(-height // 4)
    assert idx.size == 32 * tiles


@pytest.mark.parametrize("width,height", IMAGES)
def test_tile_map_gives_a_warp_one_pixel_tile(width, height):
    idx = raymarch.tile_ray_index(width * height, width).reshape(-1, 32)
    for warp in idx:
        rays = warp[warp >= 0]
        x, y = rays % width, rays // width
        assert x.max() - x.min() < 8 and y.max() - y.min() < 4
        assert x.min() % 8 == 0 and y.min() % 4 == 0
        # Lane order within the tile: row-major, 8 lanes a row.
        lanes = np.nonzero(warp >= 0)[0]
        np.testing.assert_array_equal(lanes % 8, x - x.min())
        np.testing.assert_array_equal(lanes // 8, y - y.min())


def test_tile_constants_match_the_kernel_source():
    src = (raymarch.CSRC / "raymarch.cu").read_text()
    m = re.search(r"kTileW = (\d+), kTileH = (\d+);", src)
    assert (int(m.group(1)), int(m.group(2))) == (raymarch.TILE_W,
                                                  raymarch.TILE_H)


def test_image_width_must_divide_the_rays():
    m, st = _small_state()
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    for bad in (3, 0, -2):
        with pytest.raises(ValueError, match="does not divide"):
            raymarch.trace_rays_cuda(m, st, m.params(), feats, opts,
                                     image_width=bad)


def test_trace_rays_image_width_changes_nothing_on_the_cpu():
    m, st = _small_state()
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    a = integrate.trace_rays(m, st, m.params(), feats, opts)
    b = integrate.trace_rays(m, st, m.params(), feats, opts, image_width=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_with_flags_replaces_fmad_and_keys_the_build():
    base = raymarch.NVCC_FLAGS
    assert "-fmad=false" in base
    on = raymarch.with_flags("-fmad=true", "-DGRT_THREADS=128")
    assert "-fmad=false" not in on and on[-2:] == ("-fmad=true",
                                                   "-DGRT_THREADS=128")
    assert raymarch.with_flags() == tuple(base)
    kept = raymarch.with_flags("-DGRT_FULL_TANGENTS")
    assert "-fmad=false" in kept
    hashes = {raymarch.source_hash(f) for f in (base, on, kept)}
    assert len(hashes) == 3 and raymarch.source_hash() in hashes


def test_ptxas_summary_reads_the_kernel_report():
    report = ("ptxas info    : 24 bytes gmem\n"
              "ptxas info    : Compiling entry function '_ZN3grt15raymarch_"
              "kernelINS_9KerrBoyerENS_11StepOptionsILb0ELb0ELb0EEEEEvT_' "
              "for 'sm_90a'\n"
              "ptxas info    : Function properties for raymarch_kernel\n"
              "    32 bytes stack frame, 0 bytes spill stores, 8 bytes spill "
              "loads\n"
              "ptxas info    : Used 64 registers, used 0 barriers, 32 bytes "
              "cumulative stack size\n")
    assert raymarch.ptxas_summary(report) == {
        "registers": 64, "stack_bytes": 32, "spill_store_bytes": 0,
        "spill_load_bytes": 8}
    with pytest.raises(ValueError, match="no ptxas report"):
        raymarch.ptxas_summary("nvcc warning : nothing of the kind")


@pytest.mark.parametrize("width,height", [(16, 8), (13, 7), (21, 10)])
def test_idle_lane_factor_follows_the_maps(width, height):
    """chip_smoke's idle-lane factor is, for rows, that of warps of 32 rays
    in index order and, for tiles, that of the kernel's own map."""
    rng = np.random.default_rng(width)
    n = width * height
    trials = rng.integers(1, 200, n)
    t = torch.from_numpy(trials).to(torch.int32)

    def brute(idx):
        per = np.where(idx >= 0, trials[np.maximum(idx, 0)], 0)
        return 32 * per.reshape(-1, 32).max(axis=1).sum() / trials.sum()

    rows = np.concatenate([np.arange(n), -np.ones(-n % 32, int)])
    assert chip_smoke.idle_lane_factor(t) == pytest.approx(brute(rows),
                                                           rel=1e-6)
    assert chip_smoke.idle_lane_factor(t, width) == pytest.approx(
        brute(raymarch.tile_ray_index(n, width)), rel=1e-6)
    assert chip_smoke.idle_lane_factor(torch.ones(64, dtype=torch.int32),
                                       8) == 1.0


def test_bound_is_operations_over_peak_for_a_marching_frame():
    n, trials = 2_073_600, 1_064_116_814
    bound, ops, byt = chip_smoke.bound_ms(n, trials)
    assert ops == pytest.approx(trials * chip_smoke.OPS_PER_TRIAL / 67e12
                                * 1e3)
    assert byt == pytest.approx(n * (68 + 64) / 3.35e12 * 1e3)
    assert bound == ops > byt
    # A launch that marches nothing is bound by its bytes.
    assert chip_smoke.bound_ms(n, 0)[0] == byt


def test_metric_of_the_kernel_is_registered():
    """Every kernel instance belongs to a registered metric and takes that
    metric's parameters, all of them, in the order of its C++ struct."""
    assert set(raymarch.INSTANCES) == set(metrics.REGISTRY)
    for name, (struct, param_names) in raymarch.INSTANCES.items():
        assert set(param_names) == set(metrics.get_metric(name).defaults)
        assert struct.isidentifier()


def test_smoke_counts_every_instance_it_marches():
    """``chip_smoke.py`` phase 19 bounds every instance's 1080p launch by its
    own operations per trial iteration: each metric has its 4-D count, and a
    planar one where the pipeline traces it planar; phase 26 drives the
    catalogue slices, which are the instances but for the eight of PRs 1-4."""
    for name in raymarch.INSTANCES:
        assert chip_smoke.OPS_BY_INSTANCE[name, False] > 0
        if metrics.get_metric(name).spherically_symmetric:
            assert chip_smoke.OPS_BY_INSTANCE[name, True] > 0
    first = {"kerr_boyer", "schwarzschild", "schwarzschild_fast",
             "schwarzschild_skewed", "schwarzschild_ingoing_ef", "de_sitter",
             "minkowski", "minkowski_skew"}
    assert set(chip_smoke.CATALOGUES) == set(raymarch.INSTANCES) - first
    assert len(chip_smoke.CATALOGUES) == len(set(chip_smoke.CATALOGUES)) == 23


def test_ptxas_instances_reads_every_option_instance():
    """A library's report holds one block per option instance, keyed by the
    mangled name's StepOptions<planar, euler, reparameterisation>."""
    def block(opts, regs, spill):
        return ("ptxas info    : Compiling entry function '_ZN3grt15raymarch"
                f"_kernelINS_9KerrBoyerENS_11StepOptionsILb{opts[0]}ELb"
                f"{opts[1]}ELb{opts[2]}EEEEEvT_' for 'sm_90a'\n"
                "ptxas info    : Function properties for _ZN3grt\n"
                f"    32 bytes stack frame, {spill} bytes spill stores, 0 "
                "bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 0 barriers\n")

    report = "ptxas info    : 0 bytes gmem\n" + block("000", 61, 0) \
        + block("100", 56, 0) + block("101", 50, 4)
    inst = raymarch.ptxas_instances(report)
    assert sorted(inst) == [(False, False, False), (True, False, False),
                            (True, False, True)]
    assert inst[True, False, True] == {
        "registers": 50, "stack_bytes": 32, "spill_store_bytes": 4,
        "spill_load_bytes": 0}
    assert raymarch.ptxas_summary(report)["registers"] == 61
