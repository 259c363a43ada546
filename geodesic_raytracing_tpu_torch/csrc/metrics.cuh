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
//   polar_r(x)           polar[1] of the chart's to_polar (the escape
//                        radius, and the at_origin distance)
//   origin_distance(x)   optional: the config's origin_distance where it is
//                        not at_origin (the step schedule's distance)
//   g(x0, x1, x2, x3)    the metric as a Sym of typed entries (sym.cuh); each
//                        coordinate is a dual that carries the tangent it
//                        seeds, or none (up to kTangents = 4 of them)
//   fl(x1, x2, x3)       instead of g, for a Kerr-Schild metric
//                        g = eta + f l l: the decomposition (f, l1, l2, l3)
//                        (kerr_schild.cuh), which the march's rank-1
//                        acceleration takes
// One header per family: kerr_boyer.cuh, schwarzschild.cuh, minkowski.cuh,
// exotic.cuh (Misner, the spinning string, Godel), wormhole.cuh (Janis-
// Newman-Winicour, evaporating Schwarzschild, Thorne's and Ellis's
// wormholes), warp.cuh (Alcubierre, the Krasnikov tubes, the symmetric warp
// drive), kerr_schild.cuh (Kerr and Kerr-Newman in Kerr-Schild coordinates),
// multibody.cuh (the double Schwarzschild and the three double-Kerr metrics,
// on the complex pairs of complex.cuh).
#pragma once

#include "exotic.cuh"
#include "kerr_boyer.cuh"
#include "kerr_schild.cuh"
#include "minkowski.cuh"
#include "multibody.cuh"
#include "schwarzschild.cuh"
#include "warp.cuh"
#include "wormhole.cuh"
