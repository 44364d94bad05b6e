"""Residual-VQ encode through the hand-written CUDA kernels.

* **K1** (argmin) replaces ``nat_tpu/ops/rvq_pallas.py::_rvq_kernel`` in
  argmin mode; **K2** is the same kernel's stochastic mode
  (``rvq_pallas.py:73-89``).  Source and design notes:
  ``csrc/rvq_argmin.cu``: one persistent cooperative launch per call, with
  |c|² fused into the distance pass, a 4-stage ``cp.async`` ring of depth
  slices and 8×4 outputs a thread.  ``cuda_build`` compiles it on the
  first CUDA call, in 5-8 s on an H100 host.  What bounds them on an H100 at the main
  path's shapes (N=4, K=4096, D=512, M=81): 1.36 GFLOP of fp32 FMA work
  against 33.5 MB of codebook — fp32 operations, not memory.
* **K3** replaces ``rvq_encode_pallas_train`` (``rvq_pallas.py:307-345``):
  :class:`RVQTrainEncode`, an autograd Function whose forward is K1 and
  whose backward is the reference's analytic straight-through gradient in
  torch ops (the reference's backward is jnp, not Pallas, too).

:func:`launch_plan` cuts a call on the host (row tile, shared memory,
grid) from M, K, the card's SM count and how many blocks an SM holds at
once; the kernel checks it.  The ring depth (4 slices) and the code chunk
(32) are fixed in the kernel, and no plan changes its arithmetic.
The wrappers take the plain version (:mod:`nat_tpu_torch.quant.rvq`) only
for tensors on the CPU.  A CUDA tensor launches the kernel or raises; there
is no fallback.  Each kernel has a launch count (one per call on CUDA) so
a run can show that its path went through the kernel: ``launches`` (K1),
``sample_launches`` (K2) and ``train_launches`` (K3, whose forward also
counts one K1 launch).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..quant import rvq as plain
from ..quant.rvq import RVQState

SOURCE = "rvq_argmin.cu"
launches = 0
sample_launches = 0
train_launches = 0
_lib = None

CODE_CHUNK = 32          # codes an item takes (fixed in the kernel)
SLICE = 32               # depth of one pipeline stage
STAGES = 4               # slices in flight (fixed in the kernel)
CSQ_PARTS = 4            # partial sums of |c|² a code (fixed in the kernel)
THREADS_PER_ROW = 4      # a block's threads for each row of its tile
ROW_TILES = (32, 64, 96)  # 96 rows: 384 threads, up to 168 registers each
ROW_TILE_MAX = ROW_TILES[-1]
SMEM_LIMIT = 232_448     # shared memory one block may use on sm_90


@dataclass(frozen=True)
class LaunchPlan:
    """How one call of the chain kernel on ``x [m, d]`` against ``k`` codes
    a layer is cut.  The kernel's items are (row tile × code chunk) pairs;
    ``grid_blocks`` blocks of ``THREADS_PER_ROW × row_tile`` threads walk
    them, one item at a time."""

    m: int
    k: int
    row_tile: int
    smem_bytes: int
    grid_blocks: int

    @property
    def row_tiles(self) -> int:
        return math.ceil(self.m / self.row_tile)

    @property
    def code_chunks(self) -> int:
        return math.ceil(self.k / CODE_CHUNK)

    def items(self) -> Iterator[Tuple[range, range]]:
        """``(rows, codes)`` of each item in the kernel's order: item ``i``
        takes row tile ``i % row_tiles`` and code chunk ``i // row_tiles``;
        rows past ``m`` and codes past ``k`` are masked."""
        for item in range(self.row_tiles * self.code_chunks):
            r0 = (item % self.row_tiles) * self.row_tile
            c0 = (item // self.row_tiles) * CODE_CHUNK
            yield (range(r0, min(r0 + self.row_tile, self.m)),
                   range(c0, min(c0 + CODE_CHUNK, self.k)))


def smem_bytes(row_tile: int) -> int:
    """Dynamic shared memory of one block: the ring of ``STAGES`` slices
    (``row_tile`` residual rows and ``CODE_CHUNK`` codes, each ``SLICE``
    floats padded by 4), the |c|² partial sums and K2's Gumbel noise for
    the item (``row_tile`` rows of ``CODE_CHUNK`` floats padded by 1)."""
    return 4 * (STAGES * (row_tile + CODE_CHUNK) * (SLICE + 4)
                + CSQ_PARTS * CODE_CHUNK + row_tile * (CODE_CHUNK + 1))


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, k: int, sm_count: int,
                blocks_per_sm: Tuple[int, ...]) -> LaunchPlan:
    """The plan for ``m`` rows against ``k`` codes a layer on a card of
    ``sm_count`` SMs, each holding ``blocks_per_sm[i]`` blocks of row tile
    ``ROW_TILES[i]`` at once.  Of the tilings of ``m``, the plan takes the
    one whose items need the fewest rounds over the SMs, then the one that
    leaves fewest SMs idle, then the least padding, then the fewest tiles:
    at K=4096, 81 and 88 rows are one tile of 96 (128 items); at K=1000,
    81 rows are three tiles of 32 (96 items, where one tile would give
    32)."""
    if min(m, k, sm_count) < 1 or len(blocks_per_sm) != len(ROW_TILES):
        raise ValueError(f"launch_plan: m={m}, k={k}, sm_count={sm_count} "
                         f"must be >= 1 and blocks_per_sm={blocks_per_sm} "
                         f"must give one count per row tile {ROW_TILES}")
    chunks = math.ceil(k / CODE_CHUNK)

    def cost(tiles: int):
        tile = 32 * math.ceil(math.ceil(m / tiles) / 32)
        items = tiles * chunks
        return (math.ceil(items / sm_count), -min(items, sm_count),
                tiles * tile, tiles), tile

    _, tile = min(cost(t) for t in range(math.ceil(m / ROW_TILE_MAX),
                                         math.ceil(m / 32) + 1))
    return plan_with_tile(m, k, tile,
                          sm_count * blocks_per_sm[ROW_TILES.index(tile)])


def plan_with_tile(m: int, k: int, row_tile: int, resident: int) -> LaunchPlan:
    """The plan for a given row tile (one of ``ROW_TILES``) on a card that
    holds ``resident`` blocks of it at once.  The grid gives each item a
    block, and each row a warp for its update, up to ``resident``: a
    cooperative launch cannot take more, and idle blocks only slow the grid
    barriers."""
    if row_tile not in ROW_TILES or resident < 1:
        raise ValueError(f"plan_with_tile: row tile {row_tile} (one of "
                         f"{ROW_TILES}) with {resident} resident blocks")
    tiles = math.ceil(m / row_tile)
    wanted = max(tiles * math.ceil(k / CODE_CHUNK),
                 math.ceil(m / (THREADS_PER_ROW * row_tile // 32)))
    return LaunchPlan(m=m, k=k, row_tile=row_tile,
                      smem_bytes=smem_bytes(row_tile),
                      grid_blocks=min(wanted, resident))


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int, stochastic: bool) -> Tuple[int, Tuple[int, ...]]:
    """``(SM count, blocks of each row tile an SM holds at once)`` for the
    K1 (``stochastic=False``) or K2 kernel on CUDA device ``index``.  The
    first call for a device and mode also raises the kernel's shared-memory
    limit there, which every launch needs."""
    lib = _library()
    per_sm = []
    with torch.cuda.device(index):
        for tile in ROW_TILES:
            out = ctypes.c_int(0)
            _raise_on(lib.rvq_blocks_per_sm(int(stochastic), tile,
                                            ctypes.byref(out)),
                      lib, "rvq_blocks_per_sm")
            per_sm.append(out.value)
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            tuple(per_sm))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load(SOURCE)
        buffers = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        lib.rvq_argmin_encode.argtypes = buffers + [ctypes.c_void_p]
        lib.rvq_argmin_encode.restype = ctypes.c_int
        lib.rvq_sample_encode.argtypes = buffers + [
            ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p]
        lib.rvq_sample_encode.restype = ctypes.c_int
        lib.rvq_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.rvq_blocks_per_sm.restype = ctypes.c_int
        lib.rvq_philox_uniforms.argtypes = [ctypes.c_void_p] + [
            ctypes.c_int] * 3 + [ctypes.c_uint64, ctypes.c_void_p]
        lib.rvq_philox_uniforms.restype = ctypes.c_int
        lib.rvq_error_string.argtypes = [ctypes.c_int]
        lib.rvq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"rvq kernel: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"rvq kernel: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"rvq kernel: {name} must have {ndim} dims, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rvq kernel: {name} must be contiguous")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.rvq_error_string(rc).decode()})")


def rvq_encode_cuda(codebook: torch.Tensor, x: torch.Tensor,
                    temperature: Optional[float] = None, seed: int = 0,
                    plan: Optional[LaunchPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kernel call: ``x [M, D]``, ``codebook [N, K, D]`` (float32,
    contiguous, same CUDA device) → ``(codes [N, M] int32,
    err [N, M] float32, qsum [M, D] float32)``, where ``err`` is
    ``‖r − q‖²`` after each layer's update.  ``temperature=None`` is K1
    (argmin); a temperature > 0 is K2, sampling with Philox draws keyed by
    ``seed`` (0 ≤ seed < 2**64).  ``plan`` overrides :func:`launch_plan`'s
    choice (for measuring); the results do not depend on it."""
    global launches, sample_launches
    if x.device.type != "cuda":
        raise ValueError(f"rvq kernel needs CUDA tensors, got {x.device}")
    _check("x", x, x.device, 2)
    _check("codebook", codebook, x.device, 3)
    m, d = x.shape
    n, k, dc = codebook.shape
    if dc != d:
        raise ValueError(f"rvq kernel: x dim {d} != codebook dim {dc}")
    if temperature is not None and not temperature > 0:
        raise ValueError(f"rvq kernel: temperature must be > 0, got "
                         f"{temperature}")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"rvq kernel: seed {seed} is not a 64-bit unsigned")
    if plan is not None and (plan.m, plan.k) != (m, k):
        raise ValueError(f"rvq kernel: plan for m={plan.m}, k={plan.k} given "
                         f"for m={m}, k={k}")
    if m == 0:
        return (torch.empty((n, 0), dtype=torch.int32, device=x.device),
                torch.empty((n, 0), device=x.device), x.new_empty((0, d)))
    lib = _library()
    card = resident_blocks(x.device.index if x.device.index is not None
                           else torch.cuda.current_device(),
                           temperature is not None)
    if plan is None:
        plan = launch_plan(m, k, *card)
    # 16-byte copies need every row on a 16-byte boundary; other inputs
    # take the kernel's one-float path.
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0
              and codebook.data_ptr() % 16 == 0)
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    err = torch.empty((n, m), dtype=torch.float32, device=x.device)
    qsum = torch.empty((m, d), dtype=torch.float32, device=x.device)
    residual = torch.empty((m, d), dtype=torch.float32, device=x.device)
    rsq = torch.empty((m,), dtype=torch.float32, device=x.device)
    keys = torch.empty((m,), dtype=torch.int64, device=x.device)
    args = (x.data_ptr(), codebook.data_ptr(), residual.data_ptr(),
            rsq.data_ptr(), keys.data_ptr(), codes.data_ptr(),
            err.data_ptr(), qsum.data_ptr(), m, n, k, d, plan.row_tile,
            plan.smem_bytes, plan.grid_blocks, vec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if temperature is None:
            rc = lib.rvq_argmin_encode(*args, stream)
        else:
            rc = lib.rvq_sample_encode(*args, float(temperature), seed, stream)
    _raise_on(rc, lib, "rvq_argmin_encode" if temperature is None
              else "rvq_sample_encode")
    if temperature is None:
        launches += 1
    else:
        sample_launches += 1
    return codes, err, qsum


def philox_uniforms_cuda(seed: int, num_layers: int, m: int, k: int,
                         device) -> torch.Tensor:
    """The uniforms K2 draws for ``seed``, written by the same device
    function: ``[num_layers, m, k]`` float32 on ``device``.  Feeds the
    plain version on the card; not counted as a K2 launch."""
    lib = _library()
    out = torch.empty((num_layers, m, k), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.rvq_philox_uniforms(out.data_ptr(), m, num_layers, k, seed,
                                     stream)
    _raise_on(rc, lib, "rvq_philox_uniforms")
    return out


def rvq_encode(state: RVQState, x: torch.Tensor, per_row: bool = False,
               temperature: Optional[float] = None, seed: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Residual-VQ encode of ``x [B, T, D]``: ``(codes [N, B, T],
    quantized [B, T, D], losses)``, the contract of
    :func:`nat_tpu_torch.quant.rvq.rvq_encode`.  Argmin (K1) unless a
    ``temperature`` asks for sampling (K2, keyed by ``seed``).  CPU tensors
    take the plain version (for sampling, over the same Philox uniforms);
    any other tensor goes through the kernel."""
    if x.device.type == "cpu":
        if temperature is None:
            return plain.rvq_encode(state, x, per_row=per_row)
        return plain.encode_with(plain.sampling_chain(temperature, seed),
                                 state, x, per_row)

    def chain(codebook, flat):
        return rvq_encode_cuda(codebook, flat, temperature, seed)
    return plain.encode_with(chain, state, x, per_row)


# ---------------------------------------------------------------------------
# K3: the training encode.
# ---------------------------------------------------------------------------


class RVQTrainEncode(torch.autograd.Function):
    """``(codebook [N, K, D], x [B, T, D], chain) → (codes [N, B, T],
    quantized [B, T, D], commitment, codebook, total)`` — the reference's
    ``custom_vjp`` (``rvq_pallas.py:260-323``).

    Forward: ``chain`` (K1 on the card, :func:`plain.rvq_chain` for CPU
    tensors) and the scalar losses of ``_pallas_train_fwd_impl``.  Backward:
    ``_pallas_train_bwd_impl`` — q re-gathered from the codes,
    ``post_res = x − cumsum(q)``, ``grad_x = g_quant + c·Σ post_res`` and
    ``grad_cb`` scattered per layer with ``index_add_``, skipped when the
    codebook needs no gradient (the train step moves codebooks by EMA
    only)."""

    @staticmethod
    def forward(ctx, codebook, x, chain):
        b, t, d = x.shape
        n = codebook.shape[0]
        m = b * t
        codes, err, qsum = chain(codebook, x.reshape(m, d))
        codes = codes.long()
        mean_layer = (err.sum(dim=1) / (m * d)).mean()
        ctx.save_for_backward(codebook, x, codes)
        ctx.mark_non_differentiable(codes)
        return (codes.reshape(n, b, t), qsum.reshape(b, t, d), mean_layer,
                mean_layer.clone(), 1.25 * mean_layer)

    @staticmethod
    def backward(ctx, g_codes, g_quant, g_commit, g_codebook, g_total):
        codebook, x, codes = ctx.saved_tensors
        n, k, d = codebook.shape
        b, t, _ = x.shape
        m = b * t
        q = torch.stack([cb[c] for cb, c in zip(codebook, codes)])  # [N,M,D]
        post_res = x.reshape(1, m, d) - torch.cumsum(q, dim=0)
        commit_coeff = (g_commit + 0.25 * g_total) / n * (2.0 / (m * d))
        grad_x = (g_quant.reshape(m, d)
                  + commit_coeff * post_res.sum(dim=0)).reshape(b, t, d)
        grad_cb = None
        if ctx.needs_input_grad[0]:
            cb_coeff = (g_codebook + g_total) / n * (-2.0 / (m * d))
            grad_cb = torch.zeros_like(codebook)
            for layer in range(n):
                grad_cb[layer].index_add_(0, codes[layer], post_res[layer])
            grad_cb = grad_cb * cb_coeff
        return grad_cb, grad_x, None


def rvq_encode_train(state: RVQState, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Differentiable argmin encode through K3: ``(codes [N, B, T],
    quantized [B, T, D], losses)`` with batch-mean scalar losses and the
    gradients of :func:`nat_tpu_torch.quant.rvq.rvq_encode_ste`.  The
    forward chain is the plain one for CPU tensors; any other tensor goes
    through K1 or raises.  Any codebook size: K1 masks a ragged K, so there
    is no plain fallback as at ``rvq_pallas.py:339``."""
    global train_launches
    chain = plain.rvq_chain if x.device.type == "cpu" else rvq_encode_cuda
    codes, quantized, commit, codebook_loss, total = RVQTrainEncode.apply(
        state.codebook, x, chain)
    if chain is rvq_encode_cuda:
        train_launches += 1
    return codes, quantized, {"commitment_loss": commit,
                              "codebook_loss": codebook_loss,
                              "total_vq_loss": total}
