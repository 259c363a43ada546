"""Tetrad (orthonormal frame) machinery (port of
``geodesic_raytracing_tpu.ops.tetrad``).

The batched frame basis (component-first, gab (4, 4, N)) is the one
implementation; the single-event ``frame_basis`` runs it on a batch of one.
The reference's data-dependent index swaps are mask selects.
"""

from __future__ import annotations

import torch

from .geometry import dot, inverse44, matvec

Tensor = torch.Tensor


def _dot_g_b(gab, u, v):
    """g_ab u^a v^b for (4, N) vectors against (4, 4, N)."""
    out = 0.0
    for a in range(4):
        for b in range(4):
            out = out + gab[a, b] * u[a] * v[b]
    return out


def _gram_schmidt_metric(vs: Tensor, gab: Tensor) -> Tensor:
    """Metric Gram-Schmidt of the 4 row vectors ``vs[i]`` (cl.cl:1645-1674):
    g-inner products, each leg divided by sqrt(|g(u, u)|), so a timelike
    leg normalises to g(u, u) = -1.  ``vs`` (4, 4), ``gab`` (4, 4)."""
    def dot_g(u, v):  # one reduction, not 16 products: a node is eager ops
        return torch.sum(gab * u[:, None] * v[None, :])

    def proj(u, v):
        return (dot_g(u, v) / dot_g(u, u)) * u

    u0 = vs[0]
    u1 = vs[1] - proj(u0, vs[1])
    u2 = vs[2] - proj(u0, vs[2]) - proj(u1, vs[2])
    u3 = vs[3] - proj(u0, vs[3]) - proj(u1, vs[3]) - proj(u2, vs[3])

    def norm(u):
        return u / torch.sqrt(torch.abs(dot_g(u, u)))

    return torch.stack([norm(u0), norm(u1), norm(u2), norm(u3)])


def _swap0_batched(arr, j):
    """Swap row 0 with per-item row ``j``: arr (4, N), j (N,) int."""
    ridx = torch.arange(4, device=arr.device).reshape(4, 1)
    rj = 0.0
    for i in range(4):
        rj = rj + torch.where(j == i, arr[i], torch.zeros_like(arr[i]))
    return torch.where(ridx == 0, rj[None, :],
                       torch.where(ridx == j[None, :], arr[0][None, :], arr))


def _frame_basis_swap_batched(gab: Tensor, swap: Tensor):
    """Batched ``calculate_frame_basis_with_swap_index`` (cl.cl:1761-1849).

    ``gab`` (4, 4, N); ``swap`` (N,) int32.  Returns (es (4, 4, N), tl (N,)).
    """
    n = gab.shape[-1]
    dev = gab.device
    order = torch.arange(4, device=dev, dtype=torch.int32).reshape(4, 1)
    order = order.expand(4, n)
    order = _swap0_batched(order, swap).to(torch.int32)

    def diag_gather(o_row):
        out = 0.0
        for mu in range(4):
            out = out + torch.where(o_row == mu, gab[mu, mu],
                                    torch.zeros_like(gab[mu, mu]))
        return out

    lengths = torch.stack([diag_gather(order[i]) for i in range(4)])
    nonzero = torch.abs(lengths) > 1e-5
    # first True index per item (0 when none), as argmax of a bool
    first_nz = torch.argmax(nonzero.to(torch.int32), dim=0).to(torch.int32)
    order = _swap0_batched(order, first_nz).to(torch.int32)

    vs = [
        torch.stack([(order[i] == mu).to(gab.dtype) for mu in range(4)])
        for i in range(4)
    ]

    def proj(u, v):
        return (_dot_g_b(gab, u, v) / _dot_g_b(gab, u, u))[None, :] * u

    u0 = vs[0]
    u1 = vs[1] - proj(u0, vs[1])
    u2 = vs[2] - proj(u0, vs[2]) - proj(u1, vs[2])
    u3 = vs[3] - proj(u0, vs[3]) - proj(u1, vs[3]) - proj(u2, vs[3])

    def norm(u):
        return u / torch.sqrt(torch.abs(_dot_g_b(gab, u, u)))[None, :]

    us = [norm(u0), norm(u1), norm(u2), norm(u3)]

    sorted_es = []
    for slot in range(4):
        acc = 0.0
        for i in range(4):
            acc = acc + (order[i] == slot).to(gab.dtype)[None, :] * us[i]
        sorted_es.append(acc)

    diag = torch.stack([_dot_g_b(gab, e, e) for e in sorted_es])
    tl = torch.argmin(diag, dim=0).to(torch.int32)
    tl = torch.where(torch.min(diag, dim=0).values < 0.0, tl,
                     torch.zeros_like(tl))

    es = torch.stack(sorted_es)  # (4, 4, N): es[a][mu]
    lidx = torch.arange(4, device=dev).reshape(4, 1, 1)
    e_tl = 0.0
    for i in range(4):
        e_tl = e_tl + torch.where(tl[None, :] == i, es[i],
                                  torch.zeros_like(es[i]))
    es_sw = torch.where(lidx == 0, e_tl[None],
                        torch.where(lidx == tl[None, None, :], es[0][None], es))
    return es_sw, tl


def frame_basis_batched(gab: Tensor):
    """gab (4, 4, N) -> (es (4, 4, N), tl (N,)), ``es[a][mu][n] = e_a^mu``
    with leg 0 timelike (two-pass construction of cl.cl:1852-1860)."""
    n = gab.shape[-1]
    es1, tl1 = _frame_basis_swap_batched(
        gab, torch.zeros((n,), dtype=torch.int32, device=gab.device))
    es2, tl2 = _frame_basis_swap_batched(gab, tl1)
    take_first = tl1 == 0
    es = torch.where(take_first[None, None, :], es1, es2)
    tl = torch.where(take_first, tl1, tl2)
    return es, tl


def frame_basis(gab: Tensor):
    """Single event: gab (4, 4) -> (es (4, 4), tl ())."""
    es, tl = frame_basis_batched(gab[..., None])
    return es[..., 0], tl[0]


def tetrad_inverse(es: Tensor) -> Tensor:
    """Rows are the co-frame theta^a_mu: the inverse of the matrix whose
    columns are the tetrad legs."""
    return inverse44(es.T)


def coordinate_to_tetrad(v: Tensor, inv_es: Tensor) -> Tensor:
    """v^a = theta^a_mu v^mu."""
    return matvec(inv_es, v)


def tetrad_to_coordinate(v: Tensor, es: Tensor) -> Tensor:
    """v^mu = v^a e_a^mu."""
    return matvec(es.T, v)


def get_timelike_vector(basis_speed3: Tensor, time_direction,
                        es: Tensor) -> Tensor:
    """Observer 4-velocity from a tetrad-frame 3-speed (cl.cl:2210-2225)."""
    v2 = dot(basis_speed3, basis_speed3)
    gamma = 1.0 / torch.sqrt(1.0 - v2)
    return (
        time_direction * gamma * es[0]
        + gamma * basis_speed3[0] * es[1]
        + gamma * basis_speed3[1] * es[2]
        + gamma * basis_speed3[2] * es[3]
    )


def lorentz_boost(time_basis: Tensor, observer_velocity: Tensor,
                  gab: Tensor) -> Tensor:
    """Boost B^u_v from the frame with time leg ``time_basis`` to one
    comoving with ``observer_velocity`` (arXiv:2404.05744)."""
    lT = matvec(gab, time_basis)
    luobs = matvec(gab, observer_velocity)
    gamma = -dot(lT, observer_velocity)
    delta = torch.eye(4, dtype=gab.dtype, device=gab.device)
    T = time_basis
    uobs = observer_velocity
    return (
        delta
        + (1.0 / (1.0 + gamma)) * ((T + uobs)[:, None] * (lT + luobs)[None, :])
        - 2.0 * (uobs[:, None] * lT[None, :])
    )


def boost_tetrad(es: Tensor, basis_speed3: Tensor, gab: Tensor) -> Tensor:
    """Boost a tetrad so e0 comoves with the given frame 3-speed."""
    uobs = get_timelike_vector(basis_speed3, 1.0, es)
    B = lorentz_boost(es[0], uobs, gab)
    return torch.stack([uobs, matvec(B, es[1]), matvec(B, es[2]),
                        matvec(B, es[3])])
