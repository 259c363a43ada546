"""The plain reference against the port's CPU path (its plain march) on a
64x36 frame of each configuration, at a step budget the CPU runs in
seconds: the dense frame, and the third frame of an adaptive stream (the
prepass, then the kill masks of the frames before, and the controller)."""

import pytest
from conftest import small_root

from benchmark import check, manifest, scene
from benchmark.reference import frame as rframe

CASES = [("schwarzschild_planar", "dense_still_2160", 1),
         ("kerr_boyer_flagship", "dense_still_2160", 1),
         ("kerr_boyer_flagship", "adaptive_still_2160", 3)]


def program_frame(config, mix, inputs, frames):
    from geodesic_raytracing_tpu_torch.render import pipeline

    prog = scene.program(config, mix, inputs, "cpu")
    for _ in range(frames):
        image = pipeline.render_frame(prog.metric, prog.camera, prog.params,
                                      prog.backgrounds, prog.settings,
                                      controller=prog.controller,
                                      device="cpu")
    return image


@pytest.mark.parametrize("config_name,mix_name,frames", CASES)
def test_reference_matches_the_port_on_the_cpu(tmp_path, config_name,
                                               mix_name, frames):
    root = small_root(tmp_path, width=64, height=36, max_steps=1024)
    spec = manifest.load(root)
    config = manifest.config(root, spec, config_name)
    mix = manifest.mix(root, mix_name)
    inputs = scene.inputs(config, mix, 2147483647 + frames, "cpu")
    image = program_frame(config, mix, inputs, frames)
    metric, params, settings, sky, camera = scene.reference(config, mix,
                                                            inputs, "cpu")
    ref, launches = rframe.render(metric, params, settings, sky, *camera,
                                  index=frames)
    numbers = check.compare(image, ref)
    assert numbers["px_off_share"] <= 2 / (64 * 36)
    assert launches and all(l.active <= l.rays for l in launches)
    assert image.abs().sum() > 0
