"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all at once,
and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes`` (seconds per build, where a build that
includes PyTorch's headers takes minutes). The build runs at
first use, lands in ``rls_tpu_torch/_build/`` (gitignored) and is keyed by
a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the cached library.

``--use_fast_math`` is deliberately absent: it changes how ``sqrt`` and
division round, and the kernels are held to their plain PyTorch versions
at f32 rounding.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0 (a refused launch never runs, and
only that call reports it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "check", "device_limits", "ptxas_report"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# argtypes of every C entry point: pointers and the stream as c_void_p
# (a bare Python int would be passed as a 32-bit int and cut the pointer)
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (x, lam, out, scratch, B, H, W, iterations, stream)
    "tv_fgp_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (clusters, rows, W, own_shared, out: int64[2] = shared memory per CTA,
    #  clusters resident at once)
    "tv_fgp_cluster_occupancy": (_I, _I, _I, _I, _P),
    # (x, lam, out, scratch, B, H, W, iterations, clusters, rows, own_shared,
    #  smem, stream)
    "tv_fgp_cluster_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the same, then interior, halo (the windowed route)
    "tv_fgp_windows_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (out: int[2] = SM count, opt-in shared memory per block)
    "rls_device_limits": (_P,),
    # (x0hat, scal, tab, t2, taps, kh, kw, out, scratch, counts, B, H, W,
    #  iterations, tv_iterations, method, restart, early, warm, rel_tol,
    #  sigma_fac, stream)
    "fista_tv_fused_launch": (
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _F, _F, _P,
    ),
    # (clusters, rows, W, method, dynamic, out: int64[2] = shared memory
    #  per CTA, clusters resident at once): six planes; the same for three
    "fista_tv_cluster_occupancy": (_I, _I, _I, _I, _I, _P),
    "fista_tv_tiled_cluster_occupancy": (_I, _I, _I, _I, _I, _P),
    # (x0hat, scal, tab, t2, taps, kh, kw, out, scratch, counts, prof, B, H,
    #  W, iterations, tv_iterations, method, restart, early, warm, rel_tol,
    #  sigma_fac, clusters, rows, smem, stream): six planes; the same for
    #  three
    "fista_tv_cluster_launch": (
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _F, _F, _I, _I, _I, _P,
    ),
    "fista_tv_tiled_cluster_launch": (
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _F, _F, _I, _I, _I, _P,
    ),
    # (x0hat, scal, tab, t2, taps, kh, kw, carries, window, partial,
    #  norm_part, state, counts, B, H, W, tile_rows, halo, iterations,
    #  tv_iterations, it, method, restart, early, rel_tol, sigma_fac, stream)
    "fista_tv_tiled_launch": (
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _I, _F, _F, _P,
    ),
    # (x0hat, scal, t2, taps, kh, kw, out, scratch, counts, B, H, W,
    #  iterations, cg_iterations, tv_iterations, tol_inner, positive, stream)
    "admm_tv_fused_launch": (
        _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    # (clusters, rows, W, out: int64[2] = shared memory per CTA, clusters
    #  resident at once)
    "admm_tv_cluster_occupancy": (_I, _I, _I, _P),
    # (x0hat, scal, t2, taps, kh, kw, out, scratch, counts, prof, B, H, W,
    #  iterations, cg_iterations, tv_iterations, tol_inner, positive,
    #  clusters, rows, smem, stream)
    "admm_tv_cluster_launch": (
        _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P,
    ),
    # the same two for row 5's cluster route (three planes of a band in
    # shared memory)
    "admm_tv_tiled_cluster_occupancy": (_I, _I, _I, _P),
    "admm_tv_tiled_cluster_launch": (
        _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P,
    ),
    # (x0hat, scal, t2, taps, kh, kw, planes, window, partial, state, counts,
    #  B, H, W, tile_rows, iterations, cg_iterations, tv_iterations,
    #  tol_inner, positive, stream)
    "admm_tv_tiled_launch": (
        _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    # (b, A, lam, out, part, dots, r, v, p, bar, prof, P, m, n, steps,
    #  positive, slabs, rows, groups, group_size, resident, smem, stream)
    "cgnr_fused_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P,
    ),
    # (b, A, scal, tab, out, scratch, counts, P, m, n, steps, method, kind,
    #  restart, proj, stream)
    "pgm_dense_fused_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (b, A, scal, tab, out, counts, part, rdots, xpub, bar, prof, P, m, n,
    #  steps, method, kind, restart, proj, slabs, rows, groups, group_size,
    #  resident, smem, stream)
    "pgm_dense_grid_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _P,
    ),
    # (br, bi, ar, ai, scal, tab, out, counts, part, rdots, xpub, bar, prof,
    #  P, m, n, steps, method, kind, restart, proj, slabs, rows, groups,
    #  group_size, resident, smem, stream)
    "pgm_dense_grid_cplx_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _P,
    ),
    # (br, bi, ar, ai, scal, tab, out, scratch, counts, P, m, n, steps,
    #  method, kind, restart, proj, stream)
    "pgm_dense_fused_cplx_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (clusters, H, W, out: int64[2] = shared memory per CTA, clusters
    #  resident at once)
    "fista_l1_dft_cluster_occupancy": (_I, _I, _I, _P),
    # (x0hat, scal, tab, tw, wt, out, prof, B, H, W, iterations, clusters,
    #  smem, stream)
    "fista_l1_dft_cluster_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (H, W, smem, out: int64[2] = grid CTAs resident a SM, on the card)
    "fista_l1_dft_grid_occupancy": (_I, _I, _I, _P),
    # (x0hat, scal, tab, tw, wt, out, scratch, bar, prof, B, H, W, iterations,
    #  team, slots, row_lines, col_lines, smem, stream)
    "fista_l1_dft_grid_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (clusters, team, H, W, out: int64[2] = shared memory per CTA,
    #  clusters resident at once)
    "sense_cluster_occupancy": (_I, _I, _I, _I, _P),
    # (x0hat, scal, tab, tw, wt, coils_r, coils_i, out, scratch, prof, B, H,
    #  W, C, iterations, clusters, team, smem, stream)
    "sense_cluster_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (H, W, smem, out: int64[2] = grid CTAs resident a SM, on the card)
    "sense_grid_occupancy": (_I, _I, _I, _P),
    # (x0hat, scal, tab, tw, wt, coils_r, coils_i, out, scratch, bar, prof, B,
    #  H, W, C, iterations, team, slots, per_round, row_lines, col_lines, smem,
    #  stream)
    "sense_grid_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P,
    ),
    # (clusters, team, H, W, out: int64[2] = shared memory per CTA,
    #  clusters resident at once)
    "splitbregman_cluster_occupancy": (_I, _I, _I, _I, _P),
    # (x0hat, scal, t2, tw, wt, coils_r, coils_i, out, scratch, counts, prof,
    #  B, H, W, C, iterations, iterations_inner, cg_iterations, tv_iterations,
    #  tol_inner, clusters, team, smem, stream)
    "splitbregman_cluster_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
        _I, _P,
    ),
    # (H, W, smem, out: int64[2] = grid CTAs resident a SM, on the card)
    "splitbregman_grid_occupancy": (_I, _I, _I, _P),
    # (x0hat, scal, t2, tw, wt, coils_r, coils_i, out, scratch, bar, counts,
    #  prof, B, H, W, C, iterations, iterations_inner, cg_iterations,
    #  tv_iterations, tol_inner, team, slots, per_round, row_lines, col_lines,
    #  smem, stream)
    "splitbregman_grid_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _I, _I, _P,
    ),
    # (u, scal, taps, weights, kh, kw, out, scratch, B, H, W, iterations,
    #  kind, positive, stream)
    "pdhg_fused_launch": (_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (kind, clusters, rows, W, out: int64[2] = shared memory per CTA,
    #  clusters resident at once)
    "pdhg_cluster_occupancy": (_I, _I, _I, _I, _P),
    # (u, scal, taps, weights, kh, kw, out, prof, B, H, W, iterations, kind,
    #  positive, clusters, rows, smem, stream)
    "pdhg_cluster_launch": (
        _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (ar, ai, cols, idx, x, vl, u, denom, eps, P, m, n, L, sweeps, S, reuse,
    #  prox, stream)
    "kaczmarz_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (ar, ai, cols, idx, x, vl, u, denom, eps, prof, P, m, n, L, sweeps, S,
    #  reuse, prox, groups, ring, x_lanes, vl_shared, smem, stream)
    "kaczmarz_warp_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _P,
    ),
    # (A, Gt, denom, norms, x, vl, r, eps, forced, rows, P, m, n, S, fnorm,
    #  theta, use_theta, seed, sweep, stream)
    "kaczmarz_greedy_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _U, _U, _P,
    ),
    # (A, Gt, denom, norms, u, x_in, vl_in, eps, forced, x, vl, r, rows, prof,
    #  P, m, n, S, T, fnorm, theta, use_theta, seed, sweep0, prox, refresh,
    #  ring, rows_per_thread, x_shared, smem, stream)
    "kaczmarz_greedy_solve_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
        _U, _U, _I, _I, _I, _I, _I, _I, _P,
    ),
    # (x, lam, out, outer, N, inner, group, double, route, chunk,
    #  lines_per_cta, smem | scratch bytes, scratch, prof, counts, stream)
    "tv_condat_launch": (_P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _I, _L, _P, _P, _P, _P),
    # (out: int64[5] = walker bytes in float and double, two resident CTAs'
    #  shared memory, a global route's scratch)
    "tv_condat_sizes": (_P,),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of rls_tpu_torch cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory, link to a private name, then
    # rename: a concurrent loader never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(cu)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        _run(procs)
        lib = os.path.join(tmp, target.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(lib, target)


def ptxas_report(source: str) -> dict[str, dict[str, int]]:
    """Compile ``csrc/<source>`` alone with the build's flags and
    ``-Xptxas -v`` and read ptxas's account of each kernel:
    {mangled name: {"registers", "spill_stores", "spill_loads", "stack"}}
    (bytes a thread for the last three). Needs nvcc, not a card."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", "-o",
               os.path.join(tmp, "k.o"), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    report, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return {k: v for k, v in report.items() if "registers" in v}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    target = BUILD_DIR / f"librls_tpu_torch_{_source_hash()}.so"
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rls_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rls_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = load_library().rls_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")


# an H100: SMs, and the shared memory one block may opt into (the planners'
# defaults; on a card they plan with device_limits)
SMS, SMEM_MAX = 132, 232_448


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block) of CUDA device `index`,
    for the kernels' planners; queried once per device."""
    import torch

    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        check(load_library().rls_device_limits(out), "rls_device_limits")
    return out[0], out[1]
