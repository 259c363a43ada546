"""Port parity: the recorded march of triangle rendering
(``integrate.trace_rays_recorded``) against the JAX package, and the
kernel's arithmetic driven in slots as ``ops.raymarch.
trace_rays_recorded_cuda`` drives the card.

* The plain recorded march (``trace_rays_recorded_reference``) against JAX's
  ``trace_rays_recorded`` from JAX's own launch state: the CLI's 4-D
  ``schwarzschild`` camera rays (32x32) and the ``minkowski`` rays of
  tests/test_triangles.py.  Fates and step counts equal; every slot's
  positions within 1e-4 (ROADMAP's parity rule), those of rays that end DEAD
  within 1e-3 (the rule holds escaped positions; a ray falling into the
  hole amplifies a last-ulp difference); the other final fields of the
  rays that did not die within 1e-3.
* The kernel compiled as host code by g++ (``csrc/march.cuh`` with the
  metric's emitted struct, as tests/torch_emit_host.py builds it), launched
  once per slot with a budget of ``steps_per_slot`` trial iterations and
  the launch state's |v^t|, against the plain recorded march: fates, step counts and slot
  positions as the host tests hold the instances (equal fates and steps,
  positions within 1e-4).
* The slot launches raise on CPU tensors: the card's path has no fallback.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jintegrate
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import emit, integrate, raymarch
import torch_emit_host as eh

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
DEAD_TOL = dict(rtol=1e-3, atol=1e-3)


def _jax_camera_rays(name, size, pitch=-math.pi / 2):
    """JAX's dense 4-D camera rays of the CLI's triangle layer
    (``planar=False``), as (JAX state, port state)."""
    jm = jmetrics.get_metric(name)
    settings = jpl.RenderSettings(width=size, height=size, planar=False)
    cam = JCamera.default().rotate(pitch=pitch)
    st, _, _ = jpl.init_camera_rays(jm, cam, jm.params(), settings,
                                    jintegrate.Features.for_metric(jm))
    return jm, st, carry.ray_state_from_jax(st, device="cpu")[0]


def _jax_minkowski_rays():
    """The 16 rays of tests/test_triangles.py::test_binned_matches_dense."""
    jm = jmetrics.get_metric("minkowski")
    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    st = jintegrate.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                                   jm.params(),
                                   jintegrate.Features.for_metric(jm))
    return jm, st, carry.ray_state_from_jax(st, device="cpu")[0]


# name: (rays, n_slots, steps_per_slot)
CASES = {"schwarzschild": (lambda: _jax_camera_rays("schwarzschild", 32),
                           8, 8),
         "minkowski": (_jax_minkowski_rays, 8, 32)}


@pytest.fixture(scope="module", params=sorted(CASES))
def recorded(request):
    """Both packages' recorded marches of one case, from JAX's launch
    state."""
    make, n_slots, per = CASES[request.param]
    jm, jst, st = make()
    jfin, jpath = jintegrate.trace_rays_recorded(
        jm, jst, jm.params(), features=jintegrate.Features.for_metric(jm),
        opts=jintegrate.TraceOptions(max_steps=n_slots * per),
        n_slots=n_slots, steps_per_slot=per)
    m = tmetrics.get_metric(request.param)
    feats = integrate.Features.for_metric(m)
    fin, path = integrate.trace_rays_recorded(
        m, st, m.params(), feats, integrate.TraceOptions(), n_slots=n_slots,
        steps_per_slot=per)
    return dict(name=request.param, m=m, feats=feats, st=st,
                n_slots=n_slots, per=per, fin=fin, path=path,
                jfin=carry.ray_state_from_jax(jfin, device="cpu")[0],
                jpath=np.asarray(jpath))


def _assert_states_close(got, want, dead):
    """Fates and steps equal; positions as the parity rule holds them; the
    other fields of the rays that did not die within 1e-3 (near the horizon
    the velocity and the acceleration grow, and carry a last-ulp difference
    with them; at death they are what the blow-up test stopped)."""
    np.testing.assert_array_equal(got.status.numpy(), want.status.numpy())
    np.testing.assert_array_equal(got.steps.numpy(), want.steps.numpy())
    a, b = got.position.numpy(), want.position.numpy()
    np.testing.assert_allclose(a[~dead], b[~dead], **TOL)
    np.testing.assert_allclose(a[dead], b[dead], **DEAD_TOL)
    for f in ("velocity", "acceleration", "next_ds", "running_dlambda_dnew"):
        np.testing.assert_allclose(getattr(got, f).numpy()[~dead],
                                   getattr(want, f).numpy()[~dead],
                                   err_msg=f, **DEAD_TOL)


def test_plain_recorded_march_equals_reference(recorded):
    r = recorded
    n = r["st"].position.shape[0]
    assert tuple(r["path"].shape) == (r["n_slots"] + 1, n, 4)
    assert r["path"].dtype == torch.float32
    dead = (r["jfin"].status == integrate.DEAD).numpy()
    _assert_states_close(r["fin"], r["jfin"], dead)
    np.testing.assert_array_equal(r["path"][0].numpy(), r["jpath"][0])
    got, want = r["path"].numpy(), r["jpath"]
    np.testing.assert_allclose(got[:, ~dead], want[:, ~dead], **TOL)
    np.testing.assert_allclose(got[:, dead], want[:, dead], **DEAD_TOL)
    # The march is not vacuous: rays moved, and some ended.
    assert (r["fin"].steps > 0).all()
    if r["name"] == "schwarzschild":
        assert (r["fin"].status != integrate.ACTIVE).any()


def test_terminated_rays_repeat_their_last_position(recorded):
    """A ray that ended in slot j holds its final position in every later
    slot, so its later segments are points."""
    r = recorded
    path, fin = r["path"], r["fin"]
    done = fin.status != integrate.ACTIVE
    np.testing.assert_array_equal(path[-1][done].numpy(),
                                  fin.position[done].numpy())
    moved = (path[1:] != path[:-1]).any(-1)  # (S, N)
    last = torch.where(moved, torch.arange(1, r["n_slots"] + 1)[:, None],
                       0).amax(0)
    for i in torch.nonzero(done).flatten().tolist():
        assert (path[int(last[i]):, i] == fin.position[i]).all()


def test_plain_recorded_march_is_a_scan_of_slots(recorded):
    """The plain recorded march equals the reference's scan: every ray
    takes ``steps_per_slot`` iterations of the step a slot, with the launch
    state's |v^t| as the blow-up baseline throughout (not each slot's)."""
    r = recorded
    m, feats, st = r["m"], r["feats"], r["st"]
    step = integrate.make_step_fn(m, feats, integrate.TraceOptions())
    s = integrate._StateT(st.position.T, st.velocity.T, st.acceleration.T,
                          st.next_ds, st.running_dlambda_dnew, st.status,
                          st.steps)
    fx = torch.abs(st.velocity[:, 0])
    for j in range(r["n_slots"]):
        for _ in range(r["per"]):
            s = step(s, fx, m.params())
        np.testing.assert_array_equal(s.position.T.numpy(),
                                      r["path"][j + 1].numpy())
    np.testing.assert_array_equal(s.status.numpy(), r["fin"].status.numpy())
    np.testing.assert_array_equal(s.steps.numpy(), r["fin"].steps.numpy())


@pytest.fixture(scope="module")
def slot_lib(tmp_path_factory):
    """``{metric name: (Header, entry point)}``: the emitted structs of the
    metrics marched here, built for the host (``torch_emit_host``)."""
    hs = {n: emit.emit_metric(tmetrics.get_metric(n))
          for n in ("schwarzschild", "minkowski")}
    lib = eh.build(list(hs.values()), tmp_path_factory.mktemp("slots_host"))
    return {n: (h, lib[h.struct]) for n, h in hs.items()}


def _host_recorded(lib, m, st, feats, n_slots, per):
    """The kernel's arithmetic in slots: one host 'launch' per slot, each
    from the previous one's state, every one with the launch |v^t|."""
    header, fn = lib[m.name]
    fx = np.abs(st.velocity[:, 0].numpy()).copy()
    opts = integrate.TraceOptions(max_steps=per)
    path = [st.position.numpy().copy()]
    for _ in range(n_slots):
        st = eh.host_march(fn, header, st, m.params(), feats, opts, fx)
        path.append(st.position.numpy().copy())
    return st, np.stack(path)


def test_host_kernel_in_slots_equals_plain_recorded_march(slot_lib,
                                                          recorded):
    r = recorded
    fin, path = _host_recorded(slot_lib, r["m"], r["st"], r["feats"],
                               r["n_slots"], r["per"])
    np.testing.assert_array_equal(fin.status.numpy(), r["fin"].status.numpy())
    np.testing.assert_array_equal(fin.steps.numpy(), r["fin"].steps.numpy())
    np.testing.assert_allclose(path, r["path"].numpy(), **TOL)
    for f in ("velocity", "acceleration", "next_ds", "running_dlambda_dnew"):
        np.testing.assert_allclose(getattr(fin, f).numpy(),
                                   getattr(r["fin"], f).numpy(), err_msg=f,
                                   **TOL)


def test_host_slots_take_the_launch_baseline(slot_lib):
    """A slot that recomputed the blow-up baseline from its own |v^t| would
    march differently: a ray near the horizon whose |v^t| grows during the
    march dies at a different step.  The slot launches take the launch
    value, which the one-launch march also uses, so slots of a march equal
    that march in one launch."""
    m = tmetrics.get_metric("schwarzschild")
    feats = integrate.Features.for_metric(m)
    _, _, st = _jax_camera_rays("schwarzschild", 16)
    fin, _ = _host_recorded(slot_lib, m, st, feats, 16, 8)
    one = integrate.trace_rays_reference(
        m, st, m.params(), feats, integrate.TraceOptions(max_steps=128))
    np.testing.assert_array_equal(fin.status.numpy(), one.status.numpy())
    np.testing.assert_array_equal(fin.steps.numpy(), one.steps.numpy())
    np.testing.assert_allclose(fin.position.numpy(), one.position.numpy(),
                               **TOL)


def test_slot_launches_need_cuda_tensors():
    m = tmetrics.get_metric("schwarzschild")
    feats = integrate.Features.for_metric(m)
    _, _, st = _jax_camera_rays("schwarzschild", 4)
    with pytest.raises(ValueError, match="CUDA"):
        raymarch.trace_rays_recorded_cuda(m, st, m.params(), feats,
                                          integrate.TraceOptions(), 2, 8)


def test_recorded_march_options_and_budget():
    """``opts.max_steps`` is not read (every ray has n_slots x
    steps_per_slot trial iterations, as the reference's scan), and the
    other options reach every slot."""
    m = tmetrics.get_metric("schwarzschild")
    feats = integrate.Features.for_metric(m)
    _, _, st = _jax_camera_rays("schwarzschild", 8)
    a = integrate.trace_rays_recorded(m, st, m.params(), feats,
                                      integrate.TraceOptions(max_steps=1),
                                      n_slots=4, steps_per_slot=8)
    b = integrate.trace_rays_recorded(m, st, m.params(), feats,
                                      integrate.TraceOptions(), n_slots=4,
                                      steps_per_slot=8)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert int(a[0].steps.max()) <= 32
    euler = dataclasses.replace(integrate.TraceOptions(), integrator="euler")
    c = integrate.trace_rays_recorded(m, st, m.params(), feats, euler,
                                      n_slots=4, steps_per_slot=8)
    assert not torch.equal(c[1], b[1])
