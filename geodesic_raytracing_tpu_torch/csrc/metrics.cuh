// Every metric struct the ray-march kernel is instantiated for.
//
// A metric struct M gives the march (march.cuh) its compile-time facts and
// its metric function:
//   name, n_params, from_params(const float*)   identity and parameters
//   adaptive_precision, detect_singularities, singular,
//   singular_terminator, has_cylindrical_singularity,
//   cylindrical_terminator, unconditionally_nonsingular   the MetricConfig
//   weight(i), udiv      precision weights of the chart and their maximum
//   n_deps, dep(k)       the coordinates g depends on; dep(k) seeds tangent k
//   polar_r(x)           polar[1] of the chart's to_polar (the at_origin
//                        distance and the escape radius)
//   g(x0, x1, x2, x3)    the metric as a Sym of typed entries (sym.cuh); each
//                        coordinate is a dual that carries the tangent it
//                        seeds, or none
#pragma once

#include "exotic.cuh"
#include "kerr_boyer.cuh"
#include "minkowski.cuh"
#include "schwarzschild.cuh"
