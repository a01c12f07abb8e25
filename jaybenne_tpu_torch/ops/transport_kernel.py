"""Census transport K1(a): port of ``jaybenne_tpu/ops/pallas_transport.py::
_transport_kernel`` in its single-block, gray, IMC, no-absorption, 1D configuration
(the stepdiff main path).

``transport`` runs the census for a ledger: the CUDA kernel
(``csrc/transport_kernel.cu``) for CUDA tensors, its plain version for CPU tensors.
``transport_plain`` is that plain version: a vectorised PyTorch port of the same
event body in which every lane advances one iteration per loop step, with the same
K2 draws, as the JAX kernel's lanes do. The tests hold it against the JAX kernel
under ``interpret=True``, and ``chip_smoke.py`` holds the CUDA kernel against it.

Both update the ledger tensors IN PLACE and return ``(particles, iterations,
events)``: the iteration count is the largest number of events any particle ran
(the JAX kernel's per-tile loop count), and events is an int64 total (the JAX
kernel's int32 total wraps past 2^31).

A uniform multi-block forest is first collapsed to one synthetic block, as the JAX
wrapper does (``_uniform_view``): block-local positions and indices shift to global
ones before the census and back after it.

Configurations K1(a) does not take raise ``NotImplementedError`` naming their
ROADMAP item, on every device: nothing falls back to another loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BC, not_ported
from . import cuda_lib
from .kernel_rng import DrawPool, raw_bits_plain

_BC_CODE = {BC.periodic: 0, BC.outflow: 1, BC.reflecting: 2}
_BIG = 3.0e38
_TINY = 1.0e-37


def check_supported(mesh, prm, dtype) -> None:
    """Raise ``NotImplementedError`` unless K1(a) covers the configuration."""
    if dtype != torch.float32:
        raise not_ported("precision = f64 (the XLA event loop's port)", "Queue 1, item 7")
    if prm.use_ddmc:
        raise not_ported("DDMC in the census kernel", "Queue 2, K1(c)")
    if prm.has_absorption:
        raise not_ported("absorption in the census kernel", "Queue 2, K1(b)")
    if mesh.max_level > 0:
        raise not_ported("static mesh refinement in the census kernel", "Queue 2, K1(d)")
    if prm.ndim != 1:
        raise not_ported(f"{prm.ndim}D transport in the census kernel", "Queue 2, K1(e)")


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Float32 scalars of the event body, each rounded as the JAX kernel rounds it."""

    nx: int
    dx: np.float32
    inv_dx: np.float32
    org: np.float32
    lo: np.float32
    hi: np.float32
    lo_half: np.float32
    hi_half: np.float32
    span: np.float32
    bc_lo: int
    bc_hi: int
    c: np.float32
    inv_c: np.float32
    cdt: np.float32
    inv_cdt: np.float32


def _geometry(mesh, prm, dt) -> _Geom:
    f32 = np.float32
    b = mesh.bounds
    nx = mesh.root_grid[2] * mesh.nx  # cells of the collapsed single block
    dx = (b[1] - b[0]) / nx
    c = f32(prm.c)
    cdt = c * f32(dt)
    half = f32(0.5 * mesh.finest[0])
    return _Geom(
        nx=nx,
        dx=f32(dx),
        inv_dx=f32(1.0 / dx),
        org=f32(b[0]),
        lo=f32(b[0]),
        hi=f32(b[1]),
        lo_half=f32(b[0]) + half,
        hi_half=f32(b[1]) - half,
        span=f32(b[1] - b[0]),
        bc_lo=_BC_CODE[prm.swarm_bc[0]],
        bc_hi=_BC_CODE[prm.swarm_bc[1]],
        c=c,
        inv_c=f32(1.0) / c,
        cdt=cdt,
        inv_cdt=f32(1.0) / cdt,
    )


def _inv_sigt_table(coefs, mesh):
    """Per-cell 1/sigma_t (f32) in the collapsed block's cell order. Without
    absorption sigma_t is sigma_s. In a 1D uniform forest block b holds the global
    cells [b*nx, (b+1)*nx) (block ids run along x), so block cell order already is
    the collapsed block's order."""
    return (1.0 / (coefs.sigma_s.to(torch.float32) + _TINY)).contiguous()


def _collapse(p, mesh):
    """Shift block-local state to the single synthetic block (in place)."""
    nrbx = mesh.root_grid[2]
    if nrbx == 1:
        return
    Dx = np.float32((mesh.bounds[1] - mesh.bounds[0]) / nrbx)
    bx = p.block % nrbx
    p.x += bx.to(torch.float32) * float(Dx)
    p.i += bx * mesh.nx
    p.block.zero_()


def _expand(p, mesh):
    """Inverse of ``_collapse``: recover the owning block from the global index."""
    nrbx = mesh.root_grid[2]
    if nrbx == 1:
        return
    Dx = np.float32((mesh.bounds[1] - mesh.bounds[0]) / nrbx)
    bx = torch.div(p.i, mesh.nx, rounding_mode="floor")
    p.block.copy_(bx)
    p.i -= bx * mesh.nx
    p.x -= bx.to(torch.float32) * float(Dx)


def _census_plain(p, inv_sigt, g: _Geom, seed: int, max_iters: int):
    """All lanes advance one event per loop step (the JAX kernel's tile loop over
    the whole ledger). Returns (iterations, events) as tensors."""
    dev = p.x.device
    f32 = torch.float32

    def s(v):
        return torch.tensor(float(v), dtype=f32, device=dev)

    dx, inv_dx, org = s(g.dx), s(g.inv_dx), s(g.org)
    lo, hi, lo_half, hi_half, span = s(g.lo), s(g.hi), s(g.lo_half), s(g.hi_half), s(g.span)
    c, inv_c, cdt, inv_cdt = s(g.c), s(g.inv_c), s(g.cdt), s(g.inv_cdt)
    one, zero = s(1.0), s(0.0)
    lanes = torch.arange(p.capacity, dtype=torch.int64, device=dev)

    def raw(it, tag):
        return raw_bits_plain(seed, lanes, it, tag)

    x, vx, vy, vz, tau, ci, alive = p.x, p.vx, p.vy, p.vz, p.tau, p.i, p.alive
    events = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        active = alive & (tau < one)
        if not bool(active.any()):
            break
        pool = DrawPool(raw)
        d_coll = pool.exp23(it) * inv_sigt[ci.long()]
        d_end = cdt * (one - tau)
        d_geom = torch.minimum(dx, d_end)
        fi = ci.to(f32)
        xl, xu = fi * dx, (fi + one) * dx
        tgt = torch.where(vx > 0, xu, xl)
        fxd = torch.where(vx != 0, c * (tgt - x) / torch.where(vx != 0, vx, one), _BIG)
        d_push = torch.minimum(d_geom, fxd)
        coll = active & (d_coll < d_push)
        no_coll = active & ~coll
        cr_x = no_coll & (fxd <= d_geom)
        census = no_coll & ~cr_x & (d_end <= dx)

        d = torch.where(active, torch.where(coll, d_coll, d_push), zero)
        ntau = torch.where(census, one, tau + d * inv_cdt)
        nx_ = x + vx * (d * inv_c)
        up = vx > 0
        nx_ = torch.where(cr_x, torch.where(up, xu, xl), nx_)
        nci = ci + torch.where(cr_x, torch.where(up, 1, -1), 0).to(torch.int32)

        mu = 1.0 - 2.0 * pool.u16(it)
        st = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
        nvx = torch.where(coll, c * mu, vx)
        nvy = torch.where(coll, c * st, vy)
        nvz = torch.where(coll, zero, vz)

        # domain boundaries: half-finest-cell tolerant hit test, then clip
        out_lo, out_hi = nci < 0, nci >= g.nx
        gx = org + nx_
        hit_lo = out_lo & (gx <= lo_half)
        hit_hi = out_hi & (gx >= hi_half)
        nalive = alive
        for hit, bc, sgn, wall in ((hit_lo, g.bc_lo, 1.0, lo), (hit_hi, g.bc_hi, -1.0, hi)):
            if bc == _BC_CODE[BC.reflecting]:
                gx = torch.where(hit, torch.clamp(2.0 * wall - gx, lo, hi), gx)
                nvx = torch.where(hit, -nvx, nvx)
            elif bc == _BC_CODE[BC.periodic]:
                gx = torch.where(hit, torch.clamp(gx + sgn * span, lo, hi), gx)
            else:
                nalive = nalive & ~hit
        out = (out_lo | out_hi) & nalive
        lx = gx - org
        ri = torch.clamp((lx * inv_dx).to(torch.int32), 0, g.nx - 1)
        nx_ = torch.where(out, lx, nx_)
        nci = torch.where(out, ri, torch.clamp(nci, 0, g.nx - 1))

        x.copy_(nx_)
        vx.copy_(nvx)
        vy.copy_(nvy)
        vz.copy_(nvz)
        tau.copy_(ntau)
        ci.copy_(nci)
        alive.copy_(nalive)
        events += active.sum()
        it += 1
    return torch.tensor(it, dtype=torch.int32, device=dev), events


def _check_cuda_ledger(p, coefs):
    """What the kernel takes, checked before anything touches the ledger."""
    dev = p.x.device
    floats = (p.x, p.vx, p.vy, p.vz, p.tau)
    for t in (*floats, p.i, p.block, p.alive, coefs.sigma_s):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("transport kernel: ledger tensors must be contiguous on one GPU")
    if any(t.dtype != torch.float32 for t in floats) or p.i.dtype != torch.int32:
        raise ValueError("transport kernel: f32 state and int32 cell indices only")
    if p.alive.dtype != torch.bool:
        raise ValueError("transport kernel: the alive mask must be torch.bool")
    if p.capacity >= 2**31:
        raise ValueError("transport kernel: capacity must fit in int32")


def _census_cuda(p, inv_sigt, g: _Geom, seed: int, max_iters: int):
    """One launch of the census kernel on PyTorch's current stream (no
    synchronisation); the ledger was checked by ``_check_cuda_ledger``."""
    dev = p.x.device
    events = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    cuda_lib.library().call(
        "jb_transport_1d_launch",
        p.x.data_ptr(), p.vx.data_ptr(), p.vy.data_ptr(), p.vz.data_ptr(),
        p.tau.data_ptr(), p.i.data_ptr(), p.alive.data_ptr(),
        inv_sigt.data_ptr(), p.capacity,
        g.nx, float(g.dx), float(g.inv_dx), float(g.org), float(g.lo), float(g.hi),
        float(g.lo_half), float(g.hi_half), float(g.span), g.bc_lo, g.bc_hi,
        float(g.c), float(g.inv_c), float(g.cdt), float(g.inv_cdt),
        int(max_iters), int(seed),
        events.data_ptr(), iters.data_ptr(), cuda_lib.stream_handle(dev),
    )
    cuda_lib.LAUNCHES["transport_1d"] += 1
    return iters, events


def _run(census, particles, coefs, mesh, seed, prm, dt):
    check_supported(mesh, prm, particles.x.dtype)
    g = _geometry(mesh, prm, dt)
    table = _inv_sigt_table(coefs, mesh)
    _collapse(particles, mesh)
    iters, events = census(particles, table, g, int(seed), prm.max_iters)
    _expand(particles, mesh)
    return particles, iters, events


def transport(particles, coefs, mesh, seed, prm, dt):
    """Census transport of ``particles`` (updated in place) over one step ``dt``:
    the CUDA kernel for a ledger on a GPU, the plain version for one on the CPU.
    ``seed`` is the step's signed 32-bit K2 seed. Returns
    ``(particles, iterations, events)``."""
    dev = particles.x.device.type
    if dev == "cuda":
        _check_cuda_ledger(particles, coefs)
        return _run(_census_cuda, particles, coefs, mesh, seed, prm, dt)
    if dev == "cpu":
        return _run(_census_plain, particles, coefs, mesh, seed, prm, dt)
    raise ValueError(f"transport: unsupported device {particles.x.device}")


def transport_plain(particles, coefs, mesh, seed, prm, dt):
    """The plain PyTorch version of ``transport`` on any device."""
    return _run(_census_plain, particles, coefs, mesh, seed, prm, dt)
