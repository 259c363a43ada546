"""The port's checkpoint files against the JAX package's: the same format,
so that a checkpoint written by either package loads in the other, and the
port's own round trip (tensors on the device are written from the host)."""

import numpy as np
import torch

from geodesic_raytracing_tpu.utils import checkpoint as jck
from geodesic_raytracing_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


def test_roundtrip(tmp_path):
    d = tmp_path / "ck"
    tck.save_checkpoint(d, 7, {"rs": torch.tensor(1.25), "a": np.float32(-0.5)},
                        opt_state={"m": torch.ones(3)}, extra={"note": "x"})
    step, params, opt, extra = tck.load_checkpoint(d)
    assert step == 7 and extra == {"note": "x"}
    np.testing.assert_allclose(params["rs"], 1.25)
    np.testing.assert_allclose(params["a"], -0.5)
    np.testing.assert_allclose(opt["m"], np.ones(3))
    tck.save_checkpoint(d, 8, {"rs": torch.tensor(2.0, requires_grad=True)})
    step2, params2, _, _ = tck.load_checkpoint(d)
    assert step2 == 8 and float(params2["rs"]) == 2.0
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz", "meta.json"]
    assert tck.load_checkpoint(tmp_path / "nope") is None


def test_checkpoints_cross_between_packages(tmp_path):
    """Written by the JAX package, read by the port, and the other way."""
    params = {"rs": np.float32(1.0625), "a": np.float32(-0.4375)}
    jck.save_checkpoint(tmp_path / "j", 3, params, extra={"by": "jax"})
    step, got, opt, extra = tck.load_checkpoint(tmp_path / "j")
    assert (step, extra, opt) == (3, {"by": "jax"}, {})
    tck.save_checkpoint(tmp_path / "t", 5,
                        {k: torch.tensor(float(v)) for k, v in got.items()},
                        extra={"by": "torch"})
    step, back, opt, extra = jck.load_checkpoint(tmp_path / "t")
    assert (step, extra, opt) == (5, {"by": "torch"}, {})
    for k, v in params.items():
        assert back[k].dtype == np.float32 and float(back[k]) == float(v)
