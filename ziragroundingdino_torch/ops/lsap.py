"""Exact rectangular linear sum assignment (LSAP): the plain PyTorch version,
the wrapper of the hand-written CUDA kernel, and the device dispatch.

Both are the port of the JAX package's `train/matcher.py::lsap_jax`, the
JAX train step's default matcher: Jonker-Volgenant successive shortest
augmenting paths with dual potentials, the algorithm behind
`scipy.optimize.linear_sum_assignment`. A problem is a cost matrix [Q, N]
with N <= Q (queries x targets); each target n gets a distinct query
`assignment[n]`, and the total cost is least.

`lsap_plain` runs `lsap_jax`'s loops with its f32 expressions in the same
order: per target row i, Dijkstra over the query columns with
``r = min_val + cost[i] - u[i] - v``, a strict ``<`` update, the lowest
column on ties (as `jnp.argmin`), then the dual updates and the
augmentation along `pred`. It steps all problems of a batch together (a
problem whose path has ended keeps its state), so the batch costs the
longest path of each row, not their sum; `lsap_plain.steps` counts them
(of one problem, the dependent steps of its block in the kernel). The CPU
uses it.

`lsap_cuda` launches `csrc/lsap.cu` on the costs as they are, [P, Q, N]: one
block per problem, which stages its costs once (a constant row as one
scalar, the others into shared memory as far as `launch_plan`'s slots go,
the rest into a global scratch), keeps each column's state in a thread's
registers, and takes one barrier per Dijkstra step. The same f32 operations
in the same order give the plain version's assignments exactly. Costs must
be finite: `lsap_plain` raises on any other, and the kernel, which cannot
raise without a sync, gives such a problem the assignment n -> n.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ziragroundingdino_torch.ops import cuda_build

MAX_Q = 8192  # queries: 20 bytes of shared memory each (and 8 a target) must fit 227 KB
THREADS = 256  # a block per problem
COLS_PER_THREAD = (1, 2, 4, 8, 16, 32)  # the kernel's instances: columns a thread owns
SMEM_LIMIT = 232_448  # shared memory a block may use on sm_90
SMEM_RESERVE = 1024  # left to the kernel's static shared memory


class LaunchPlan(NamedTuple):
    cols_per_thread: int  # the kernel instance
    threads: int
    smem_bytes: int  # dynamic shared memory
    slots: int  # target rows held in shared memory


def launch_plan(q: int, n: int) -> LaunchPlan:
    """The kernel's launch at Q queries and N targets: the smallest instance
    whose threads own every column; shared memory for the column and row
    state (20 bytes a query, 8 a target, as `csrc/lsap.cu::fixed_bytes`) and
    as many rows of Q | 1 floats as fit the rest."""
    _check_sizes(q, n)
    cpt = next(k for k in COLS_PER_THREAD if k * THREADS >= q)
    fixed = -(-(20 * q + 8 * n) // 16) * 16
    row = 4 * (q | 1)
    slots = max(0, min(n, (SMEM_LIMIT - SMEM_RESERVE - fixed) // row))
    return LaunchPlan(cpt, THREADS, fixed + slots * row, slots)


def lsap_plain(cost: torch.Tensor) -> torch.Tensor:
    """[P, Q, N] f32 costs, N <= Q -> [P, N] int64: the query of each target."""
    p, q, n = _check(cost)
    if not bool(torch.isfinite(cost).all()):
        raise ValueError("lsap: the costs must be finite")
    dev = cost.device
    c = cost.float().transpose(1, 2)  # [P, N, Q]: rows = targets
    u = torch.zeros(p, n, device=dev)
    v = torch.zeros(p, q, device=dev)
    col4row = torch.full((p, n), -1, dtype=torch.long, device=dev)
    row4col = torch.full((p, q), -1, dtype=torch.long, device=dev)
    problems = torch.arange(p, device=dev)
    for cur_row in range(n):
        # Dijkstra from cur_row over the columns
        shortest = torch.full((p, q), float("inf"), device=dev)
        pred = torch.full((p, q), cur_row, dtype=torch.long, device=dev)
        scanned = torch.zeros(p, q, dtype=torch.bool, device=dev)
        i = torch.full((p,), cur_row, dtype=torch.long, device=dev)
        sink = torch.full((p,), -1, dtype=torch.long, device=dev)
        min_val = torch.zeros(p, device=dev)
        for _ in range(q):
            active = sink < 0
            if not bool(active.any()):
                break
            lsap_plain.steps += 1
            r = min_val[:, None] + c[problems, i] - u[problems, i][:, None] - v
            upd = active[:, None] & ~scanned & (r < shortest)
            pred = torch.where(upd, i[:, None], pred)
            shortest = torch.where(upd, r, shortest)
            masked = shortest.masked_fill(scanned, float("inf"))
            j = torch.argmin(masked, dim=1)  # the first of equal minima
            min_val = torch.where(active, masked[problems, j], min_val)
            scanned = scanned | (active[:, None] & (torch.arange(q, device=dev) == j[:, None]))
            free = row4col[problems, j] < 0
            sink = torch.where(active & free, j, sink)
            i = torch.where(active & ~free, row4col[problems, j], i)
        # the dual updates (scipy's `_lsap` semantics)
        u[:, cur_row] += min_val
        col_of_row = col4row.clamp(min=0)
        row_scanned = (col4row >= 0) & torch.gather(scanned, 1, col_of_row)
        row_scanned[:, cur_row] = False
        u = torch.where(row_scanned,
                        u + min_val[:, None] - torch.gather(shortest, 1, col_of_row), u)
        v = torch.where(scanned, v + shortest - min_val[:, None], v)
        # the augmentation along pred from the sink
        for b in range(p):
            j = int(sink[b])
            while True:
                row = int(pred[b, j])
                row4col[b, j] = row
                prev = int(col4row[b, row])
                col4row[b, row] = j
                if row == cur_row:
                    break
                j = prev
    return col4row


lsap_plain.steps = 0  # Dijkstra steps taken (all problems of a call step together)


def _check(cost: torch.Tensor):
    if cost.dim() != 3:
        raise ValueError(f"lsap: cost must be [P, Q, N], got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise ValueError(f"lsap: cost must be float32, got {cost.dtype}")
    p, q, n = cost.shape
    _check_sizes(q, n)
    return p, q, n


def _check_sizes(q: int, n: int) -> None:
    if n > q:
        raise ValueError(f"lsap: N={n} targets exceed Q={q} queries")
    if q > MAX_Q:
        raise ValueError(f"lsap: Q={q} queries exceed the kernel's {MAX_Q}")


@functools.lru_cache(maxsize=None)
def _function():
    fn = cuda_build.load("lsap").lsap_f32
    # cost [P, Q, N], out [P, N] int64, scratch, P, N, Q, cols_per_thread, slots,
    # smem_bytes, stream
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lsap_cuda(cost: torch.Tensor) -> torch.Tensor:
    """The assignment of `lsap_plain` on the card, in one launch: [P, Q, N]
    f32 CUDA costs (the matcher's contiguous layout, read as it is) -> [P, N]
    int64. Rows that may not fit shared memory get a scratch of P x (N -
    slots) x Q floats."""
    p, q, n = _check(cost)
    if not cost.is_cuda:
        raise ValueError(f"lsap_cuda: cost is on {cost.device}, not a CUDA device")
    out = torch.empty((p, n), dtype=torch.long, device=cost.device)
    if p == 0 or n == 0:
        return out
    plan = launch_plan(q, n)
    cost = cost.detach().contiguous()
    scratch = (torch.empty((p, n - plan.slots, q), device=cost.device)
               if plan.slots < n else None)
    dev = cost.get_device()
    with torch.cuda.device(dev):
        err = _function()(cost.data_ptr(), out.data_ptr(),
                          None if scratch is None else scratch.data_ptr(), p, n, q,
                          plan.cols_per_thread, plan.slots, plan.smem_bytes,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lsap: kernel launch failed with CUDA error {err}")
    lsap_cuda.launches += 1
    return out


lsap_cuda.launches = 0


def lsap(cost: torch.Tensor) -> torch.Tensor:
    """The exact assignment of [P, Q, N] costs: the kernel for a CUDA
    tensor, `lsap_plain` for a CPU one."""
    return lsap_cuda(cost) if cost.is_cuda else lsap_plain(cost)
