"""geodesic_raytracing_tpu_torch — the PyTorch / CUDA port of the raytracer.

A second package beside ``geodesic_raytracing_tpu`` (the JAX reference, which
it never imports).  Module paths and names mirror the reference so each
counterpart is found at once: ``metrics/base.py``, ``ops/geometry.py``,
``ops/integrate.py``, ``render/pipeline.py``, ...

Idiom:

* plain functions on ``torch.Tensor``; internals are component-first
  ``(4, N)`` batches, public layouts are the reference's (``RayState``
  vectors ``(N, 4)``, images ``(H, W, 3)``) so tests compare like with like;
* float32 throughout, on the ``device`` every public entry point takes;
* frozen dataclasses / NamedTuples for configuration and state.  The
  renderer has no learned weights, so nothing here is an ``nn.Module``.

The ray march runs as a hand-written CUDA kernel (``csrc/``, built with
nvcc at first use, see ``ops/raymarch.py``) for tensors on a GPU, and as its
plain eager-torch twin (``ops/integrate.trace_rays_reference``) for tensors
on the CPU.

Slices ported so far: the dense and the adaptive ``render_frame`` for
``kerr_boyer`` and for the seven metrics of ``metrics/catalogue_simple.py``
(planar mode for the spherically symmetric ones), every branch of the
integrator step, and redshift colour.
"""

__version__ = "0.1.0"

from . import metrics  # noqa: F401  (populates the metric registry)
