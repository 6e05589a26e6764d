"""Public SpMV API: ``y = alpha * A @ x + beta * y`` with Serpens-formatted A.

The paper's contract (Sec. 1) including the CompY (α, β) epilogue, on one
device.  :class:`SerpensOperator` runs any channel-shard plan
(:mod:`repro_torch.core.partition`) — one shard or many, matvec or
matmat — through the single dispatch point ``kernels/ops.run_stream``,
with the hot-row aux-spill epilogue applied per shard and the
balanced-lane ``row_perm`` gather at the end.  :class:`SerpensSpMV` is the
classic single-shard operator (preprocessing on the host, exactly like the
paper's offline format conversion; construct once, apply to many vectors).

Results are fp32 tensors on the operator's device.  Inputs may be numpy
arrays or tensors; floating inputs are cast to fp32 once, on entry.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import format as sformat
from repro_torch.core import partition as cpart
from repro_torch.kernels import ops

_MESH_SLICE = "the multi-GPU slice of the port"


class SerpensOperator:
    """y = α·A·x + β·y for a fixed sparse A under a channel-shard plan.

    A multi-shard plan executes shard by shard on the operator's device
    (row partition: shard accumulators concatenate; col partition: partial
    y's sum).  ``device`` defaults to CUDA; pass ``device="cpu"`` for the
    plain PyTorch path.
    """

    def __init__(self, plan: cpart.ChannelShardPlan, *, device=None,
                 backend: str = "auto", mesh=None, axis: str | None = None):
        if mesh is not None or axis is not None:
            raise NotImplementedError(
                f"mesh execution (shard_map in the reference) waits for "
                f"{_MESH_SLICE}")
        self.plan = plan
        self.config = plan.config
        self.shape = tuple(plan.shape)
        self.device = ops.resolve_device(device)
        # Resolved once at bind time, against the device.
        self.backend = ops.resolve_backend(backend, self.device)
        # lane_assign="balanced" plans encode row r at virtual row
        # row_perm[r]; the final gather restores caller row order.
        self._row_perm = (None if plan.row_perm is None else
                          torch.from_numpy(np.asarray(plan.row_perm,
                                                      np.int64))
                          .to(self.device))
        self._shards = [ops.device_arrays(sm, self.device)
                        for sm in plan.shards]
        self._auxs = [
            tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in (sm.aux_rows, sm.aux_cols, sm.aux_vals))
            if sm.n_aux else None
            for sm in plan.shards]
        held = ([t for dev in self._shards for t in dev]
                + [t for aux in self._auxs if aux is not None for t in aux])
        if self._row_perm is not None:
            held.append(self._row_perm)
        self._device_bytes = int(sum(t.numel() * t.element_size()
                                     for t in held))

    # -- properties -------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.plan.nnz

    @property
    def value_dtype(self) -> str:
        """Precision of the streamed values ("float32" or "bfloat16");
        accumulation and outputs are fp32 either way."""
        return self.config.value_dtype

    @property
    def supports_fused_epilogue(self) -> bool:
        """Whether :meth:`matvec_fused` can run on this operator.

        The fused epilogue needs the *complete* accumulator of one stream
        pass, so it requires a single-shard plan (multi-shard needs a
        cross-shard combine first), no aux spill side-stream (its
        contributions land after the stream pass), and no balanced-lane
        row permutation (the epilogue sees the virtual row order, not the
        caller's).  The port has no mesh binding yet.
        """
        return (self.plan.num_shards == 1 and self.plan.n_aux == 0
                and self.plan.row_perm is None)

    @property
    def device_bytes(self) -> int:
        """Bytes of the device tensors this operator holds (the streamed
        idx/val/seg arrays, the aux spill triples and ``row_perm``) — what
        the registry's byte budget charges for a live binding."""
        return self._device_bytes

    @property
    def stream_bytes(self) -> int:
        return self.plan.stream_bytes

    @property
    def padding_ratio(self) -> float:
        return self.plan.padding_ratio

    @property
    def padded_slots(self) -> int:
        return int(self.plan.idx.size)

    def cost_report(self, **_):
        raise NotImplementedError(
            "cost_report needs the profiling module (obs/profile), which "
            "waits for a later slice of the port")

    def with_mesh(self, mesh, axis: str, partition: str | None = None):
        if mesh is None:
            return self
        raise NotImplementedError(f"with_mesh waits for {_MESH_SLICE}")

    # -- compute ----------------------------------------------------------
    def _check_x(self, x, what: str):
        k = self.shape[1]
        if x.dim() < 1 or x.shape[0] != k:
            raise ValueError(
                f"{what} has shape {tuple(x.shape)}; matrix of shape "
                f"{self.shape} needs leading dimension K={k}")

    def _coerce(self, x, what: str):
        """Boundary dtype policy: floating inputs cast to the fp32 compute
        dtype exactly once, here — a float64 x must not silently promote
        the whole compute, and integer/bool inputs are a caller bug.
        Host arrays move to the operator's device; a tensor already on
        another device is refused rather than moved."""
        if isinstance(x, torch.Tensor):
            if x.device.type != self.device.type:
                raise ValueError(
                    f"{what} is on {x.device}; this operator runs on "
                    f"{self.device}")
            floating = x.is_floating_point()
            dtype = x.dtype
        else:
            x = np.asarray(x)
            floating = np.issubdtype(x.dtype, np.floating)
            dtype = x.dtype
            if floating:
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if not floating:
            raise TypeError(
                f"{what} must have a floating dtype, got {dtype} "
                f"(cast explicitly if an integer input is intentional)")
        return x.to(device=self.device, dtype=torch.float32)

    def matvec(self, x, backend: str | None = None):
        """Raw A @ x (no epilogue)."""
        x = self._coerce(x, "x")
        if x.dim() != 1:
            raise ValueError(
                f"matvec needs a 1-D x, got shape {tuple(x.shape)} "
                f"(use matmat for multi-vector)")
        self._check_x(x, "x")
        return self._apply(x, backend or self.backend)

    def __call__(self, x, alpha=1.0, beta=0.0, y=None, backend=None):
        """The paper's full SpMV: y_out = α·A·x + β·y (CompY epilogue)."""
        acc = self.matvec(x, backend=backend)
        if y is None:
            return float(alpha) * acc
        return float(alpha) * acc + float(beta) * self._coerce(y, "y")

    def matmat(self, x_mat, alpha=1.0, beta=0.0, y=None, backend=None):
        """Multi-vector SpMM (batched serving)."""
        x_mat = self._coerce(x_mat, "x_mat")
        if x_mat.dim() != 2:
            raise ValueError(
                f"matmat needs a (K, N) matrix, got shape "
                f"{tuple(x_mat.shape)}")
        self._check_x(x_mat, "x_mat")
        acc = self._apply(x_mat, backend or self.backend)
        if y is None:
            return float(alpha) * acc
        return float(alpha) * acc + float(beta) * self._coerce(y, "y")

    # -- fused epilogue (solver hot path) ---------------------------------
    def to_acc_layout(self, v):
        """Flat length-M vector → the kernel's (R, LANES) accumulator
        layout (a new tensor on the operator's device).  Lane-stationary
        rows put global row r at acc[r // LANES, r % LANES], so flat↔acc
        is a pure pad + reshape."""
        v = self._coerce(v, "v")
        rp = self.plan.out_rows_padded
        if v.dim() != 1 or v.shape[0] > rp:
            raise ValueError(f"v shaped {tuple(v.shape)} does not fit the "
                             f"{rp}-row accumulator")
        # Always a copy: the fused solvers update their state in place,
        # and must not write into a caller's x0 or r0.
        acc = torch.zeros(rp, dtype=torch.float32, device=self.device)
        acc[: v.shape[0]] = v
        return acc.reshape(-1, self.config.lanes)

    def from_acc_layout(self, a):
        """(R, LANES) accumulator layout → flat length-M vector (a view)."""
        return a.reshape(-1)[: self.shape[0]]

    def matvec_fused(self, x, epilogue, extras=(), backend=None, loop=None):
        """One-pass ``A @ x`` + fused epilogue (see
        :func:`repro_torch.kernels.ops.run_stream_fused`).

        ``epilogue(acc2d, *extras)`` receives the (R, LANES) fp32
        accumulator over *padded* rows (rows ≥ M are zero).  Only
        available when :attr:`supports_fused_epilogue`; the solvers use
        the unfused body otherwise.  x is not padded: the kernel reads it
        in place, so a solver passes a view of its state.  A registered
        epilogue updates its state extras in place, and ``loop`` (a
        :class:`~repro_torch.kernels.serpens_spmv.FusedLoop`) makes the
        step one iteration of a device-side loop.

        Returns ``(acc_flat, outs)`` — ``acc_flat`` over padded rows.
        """
        if not self.supports_fused_epilogue:
            raise ValueError(
                "fused epilogue needs a single-shard, mesh-free plan with "
                "no aux spill and modulo lane assignment (got "
                f"shards={self.plan.num_shards}, mesh=False, "
                f"n_aux={self.plan.n_aux}, "
                f"lane_assign={self.plan.spec.lane_assign!r})")
        x = self._coerce(x, "x")
        if x.dim() != 1:
            raise ValueError("matvec_fused needs a 1-D x")
        self._check_x(x, "x")
        idx, val, seg = self._shards[0]
        cfg = self.config
        return ops.run_stream_fused(
            idx, val, seg, x, epilogue=epilogue, extras=extras,
            num_rows_padded=self.plan.out_rows_padded,
            segment_width=cfg.segment_width,
            tiles_per_chunk=cfg.tiles_per_chunk,
            backend=backend or self.backend, loop=loop)

    def _finish(self, acc):
        """Virtual accumulator → caller row order (leading axis).

        Modulo plans just drop the padding tail; balanced plans gather
        through the LPT permutation — one device gather in place of the
        slice, the entire runtime cost of ``lane_assign="balanced"``.
        """
        if self._row_perm is not None:
            return acc[self._row_perm]
        return acc[: self.shape[0]]

    def _shard_acc(self, dev, aux, xl, run):
        """One shard's accumulate + its aux-spill epilogue against local x."""
        idx, val, seg = dev
        acc = run(idx, val, seg, xl)
        if aux is not None:
            ar, ac, av = aux
            xa = xl[ac]
            contrib = av * xa if xl.dim() == 1 else av[:, None] * xa
            acc.index_add_(0, ar, contrib)
        return acc

    def _apply(self, x, backend):
        """Raw A @ x over the plan (x: 1-D or (K, N)) in caller row order."""
        plan, cfg = self.plan, self.config
        kp = plan.num_segments_local * cfg.segment_width
        run = functools.partial(
            ops.run_stream, num_rows_padded=plan.out_rows_padded,
            segment_width=cfg.segment_width,
            tiles_per_chunk=cfg.tiles_per_chunk, backend=backend)
        if plan.spec.partition == "col" and plan.num_shards > 1:
            xp = ops.pad_rows(x, plan.num_shards * kp)
            acc = None
            for d, (dev, aux) in enumerate(zip(self._shards, self._auxs)):
                part = self._shard_acc(dev, aux, xp[d * kp:(d + 1) * kp],
                                       run)
                acc = part if acc is None else acc + part
            return self._finish(acc)
        xp = ops.pad_rows(x, kp)
        outs = [self._shard_acc(dev, aux, xp, run)
                for dev, aux in zip(self._shards, self._auxs)]
        if plan.num_shards == 1:
            return self._finish(outs[0])
        return self._finish(torch.cat([o[:plan.block_m] for o in outs]))

    def to_dense(self) -> np.ndarray:
        """Densify (testing only)."""
        r, c, v = self.plan.to_coo()
        out = np.zeros(self.shape, np.float32)
        np.add.at(out, (r, c), v)
        return out


class SerpensSpMV(SerpensOperator):
    """The classic single-shard operator: one Serpens stream, one device."""

    def __init__(self, rows, cols, vals, shape,
                 config: sformat.SerpensConfig = sformat.SerpensConfig(),
                 backend: str = "auto", device=None):
        plan = cpart.make_plan(rows, cols, vals, shape, config,
                               cpart.PlanSpec())
        super().__init__(plan, backend=backend, device=device)
        self.host = plan.shards[0]


def from_dense(a: np.ndarray, config=sformat.SerpensConfig(),
               backend="auto", device=None) -> SerpensSpMV:
    rows, cols = np.nonzero(a)
    return SerpensSpMV(rows, cols, a[rows, cols], a.shape, config, backend,
                       device)


class ShardedSerpensSpMV(SerpensOperator):
    """Row- or column-partitioned SpMV over a mesh axis (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"ShardedSerpensSpMV waits for {_MESH_SLICE}")
