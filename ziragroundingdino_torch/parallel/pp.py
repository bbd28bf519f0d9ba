"""Pipeline parallelism over the feature-enhancer (encoder) stack, the port
of the JAX package's `parallel/pp.py` (`:1-261`). The reference has none;
the JAX package runs a GPipe over the encoder's layers in GSPMD (stacked
per-stage parameters, a `lax.scan` of M + P - 1 steps whose `jnp.roll`
lowers to a collective-permute). Here each process of the mesh's pipe axis
is one stage and the schedule is written out:

  * `pipeline_parallel(mesh, microbatches=None)` is a context, as JAX's:
    inside it `models.transformer.FeatureEnhancer` hands its layers to
    `pipelined_enhancer`. Stage p of P runs encoder layers
    [p * chunk, (p + 1) * chunk), chunk = enc_layers / P, each the loop's
    fusion -> text -> deformable step (`FeatureEnhancer.layer_step`, with
    its remat), on M = min(microbatches or P, local batch) equal
    microbatches;
  * forward (`_GPipe`): stage p takes microbatch j from stage p - 1, runs
    its layers on it and hands (src, text, the adapter loss so far) to
    stage p + 1, keeping the microbatch's graph. A transfer is a
    `broadcast` in the group of the two neighbouring stages
    (`parallel.mesh.Mesh.boundaries`): a gloo `send` / `recv` pair on card
    tensors aborted the process (`parallel/dist.py`). The last stage's
    outputs go to every pipe rank in one broadcast over the pipe line, and
    the backbone, BERT, the decoder, the heads and the losses run
    replicated, as in JAX;
  * backward: the reverse schedule. The last stage takes the gradient of
    its own replicated loss (every rank's loss is the same one: no sum over
    ranks), each stage differentiates its kept graphs and hands d(src,
    text) and the d pos summed so far down to the stage before; stage 0's
    input gradients (d src, d pos, d text) go to every pipe rank in one
    broadcast, which is how the trainable Swin and BERT branches upstream
    of the encoder get their gradient on every rank. Every rank issues
    every collective in one fixed order, forward and backward;
  * every rank keeps whole weights (JAX's `param_sharding` has no pipe
    rule): the node takes every encoder layer's trainable parameters on
    every rank, a stage differentiates its own and puts zeros for the
    others', and one all-reduce over the pipe line sums them before the
    backward returns them, so that each backward adds its gradient once on
    every rank (and DDP's hooks see the sum); a replicated trainable
    parameter takes the mean over the pipe axis in the optimizer
    (`parallel.tp.mean_replicated_grads_`: the card's unordered MSDA
    atomics leave the ranks' gradients a few bits apart);
  * dropout: every rank draws every encoder layer's masks in the loop's
    order at the local batch's shape (so the generator ends where the loop
    leaves it), keeps its own stage's, and its layers take each
    microbatch's rows of them (`MicrobatchMasks`, in the generator's place;
    remat replays them). JAX's PP folds its dropout key per layer and
    microbatch (`:148-151,176-178` there): its masks are not the loop's;
  * the adapter loss is the mean over the equal microbatches of each
    chain's sum, the loop's sum of per-layer batch means (`:258-260`).

Under `no_grad` or `inference_mode` nothing is kept and only the forward's
transfers run. PP composes with the data and model axes (a stage's layers
are then tensor-parallel, and its transfers join the ranks of one model
coordinate); sequence parallelism shards the same activations and is
refused, as in JAX.
"""

from __future__ import annotations

import contextlib
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ziragroundingdino_torch.parallel import dist, sp

PIPE_AXIS = "pipe"

# the collectives this process joined: broadcasts between neighbouring
# stages ("boundary") and over the whole pipe line ("pipe"), and the
# all-reduces of the encoder layers' gradients over the pipe line ("grads")
COUNTS = {"boundary": 0, "pipe": 0, "grads": 0}

_STACK: list = []


@contextmanager
def pipeline_parallel(mesh, microbatches: Optional[int] = None):
    """Pipeline the encoder over the mesh's pipe axis inside the context;
    `microbatches` defaults to the pipe size (GPipe's M = P). The local
    batch must be divisible by the microbatches."""
    if PIPE_AXIS not in mesh.axes:
        raise ValueError(f"mesh {mesh} has no '{PIPE_AXIS}' axis; build it with "
                         "make_mesh(..., pipe=N)")
    _STACK.append((mesh, microbatches))
    try:
        yield
    finally:
        _STACK.pop()


def active():
    """(mesh, microbatches) of the innermost `pipeline_parallel` whose pipe
    axis has more than one rank; else None."""
    if not _STACK:
        return None
    mesh, m = _STACK[-1]
    return (mesh, m) if mesh.pipe > 1 else None


def _mask_shapes(enhancer, i: int, b: int, s: int, t: int) -> List[Tuple[int, ...]]:
    """The shapes of the masks that encoder layer i draws at batch b, S = s
    image and T = t text tokens, in the order it draws them: the fusion
    layer's attention dropout (image->text, then text->image, [b, heads, s,
    t]) and drop path (image, then text), then the text layer's attention
    dropout ([b, heads, t, t]). `MicrobatchMasks` holds the layers to them."""
    shapes = []
    if enhancer.fusion_layers is not None:
        f = enhancer.fusion_layers[i]
        if f.attn.dropout > 0.0:
            shapes += [(b, f.attn.num_heads, s, t)] * 2
        if f.drop_path > 0.0:
            shapes += [(b, 1, 1)] * 2
    if enhancer.text_layers is not None:
        a = enhancer.text_layers[i].self_attn
        if a.dropout > 0.0:
            shapes.append((b, a.num_heads, t, t))
    return shapes


class MicrobatchMasks:
    """In a stage's layers, the generator's place for one microbatch: each
    `uniform(shape)` gives rows [lo, hi) of the next mask that the loop
    would have drawn at the whole local batch (`draws`, in order), and
    raises where the layer asks for another shape or more masks than were
    drawn. `get_state` / `set_state` let remat replay them."""

    def __init__(self, draws: Sequence[torch.Tensor], lo: int, hi: int):
        self.draws, self.lo, self.hi, self.cursor = draws, lo, hi, 0

    def uniform(self, shape: Tuple[int, ...]) -> torch.Tensor:
        if self.cursor >= len(self.draws):
            raise RuntimeError(f"a pipeline stage drew a mask of shape {shape} beyond the "
                               f"{len(self.draws)} of its layers (`pp._mask_shapes`)")
        full = self.draws[self.cursor]
        want = (self.hi - self.lo,) + tuple(full.shape[1:])
        if shape != want:
            raise RuntimeError(f"a pipeline stage drew a mask of shape {shape} where its "
                               f"layers draw {want} (`pp._mask_shapes`)")
        self.cursor += 1
        return full[self.lo:self.hi]

    def get_state(self) -> int:
        return self.cursor

    def set_state(self, cursor: int) -> None:
        self.cursor = cursor


_ALIGN = 16  # bytes; every packed tensor starts at a multiple of this


def _nbytes(spec) -> int:
    """A tensor's bytes in a packed buffer, its padding included."""
    shape, dtype = spec
    n = torch.Size(shape).numel() * dtype.itemsize
    return n + (-n) % _ALIGN


def _pack(tensors: Sequence[torch.Tensor], specs) -> torch.Tensor:
    """The tensors' bytes, each padded to _ALIGN, in one uint8 buffer."""
    parts = []
    for t, (shape, dtype) in zip(tensors, specs):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise RuntimeError(f"a pipeline transfer of {tuple(t.shape)} {t.dtype} where both "
                               f"ranks expect {tuple(shape)} {dtype}")
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(raw)
        pad = (-raw.numel()) % _ALIGN
        if pad:
            parts.append(raw.new_zeros(pad))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, specs) -> List[torch.Tensor]:
    out, off = [], 0
    for shape, dtype in specs:
        size = torch.Size(shape).numel() * dtype.itemsize
        out.append(buf[off:off + size].view(dtype).reshape(shape))
        off += _nbytes((shape, dtype))
    return out


def _broadcast(group, src: int, tensors: Optional[Sequence[torch.Tensor]], specs, device,
               kind: str) -> List[torch.Tensor]:
    """`tensors` (on the rank `src`, a global rank) on every rank of
    `group`, packed into one broadcast; the others pass None and get them
    in `specs`' shapes and dtypes."""
    COUNTS[kind] += 1
    if dist.process_index() == src:
        tdist.broadcast(_pack(tensors, specs), src=src, group=group)
        return [t.detach() for t in tensors]
    buf = torch.empty(sum(_nbytes(s) for s in specs), dtype=torch.uint8, device=device)
    tdist.broadcast(buf, src=src, group=group)
    return _unpack(buf, specs)


class _Stage:
    """This rank's stage of one pipelined encoder call: its layers, the
    microbatches' inputs that every stage takes alike, the masks, and, in
    a train forward, each microbatch's kept graph."""

    def __init__(self, enhancer, mesh, n_micro, src, pos, text, reference_points,
                 spatial_shapes, key_padding_mask, text_token_mask, text_self_attention_masks,
                 pos_text, generator):
        self.enhancer, self.mesh, self.n_micro = enhancer, mesh, n_micro
        self.n_pipe = mesh.pipe
        self.group, _, self.stage = mesh.axes[PIPE_AXIS]
        chunk = enhancer.cfg.enc_layers // self.n_pipe
        self.layers = range(self.stage * chunk, (self.stage + 1) * chunk)
        b, s, _ = src.shape
        self.bm = b // n_micro
        self.device = src.device
        self.spatial_shapes = spatial_shapes
        self.fixed = (reference_points, key_padding_mask, text_token_mask,
                      text_self_attention_masks, pos_text)
        # what every transfer holds, known alike on both of its ranks
        self.src_spec = ((self.bm,) + tuple(src.shape[1:]), src.dtype)
        self.text_spec = ((self.bm,) + tuple(text.shape[1:]), text.dtype)
        self.need_pos = pos.requires_grad
        # every layer's masks, in the loop's order; the stage's own kept
        self.draws = None
        if generator is not None:
            self.draws = []
            for i in range(enhancer.cfg.enc_layers):
                draws = [torch.rand(shape, generator=generator, device=self.device)
                         for shape in _mask_shapes(enhancer, i, b, s, text.shape[1])]
                if i in self.layers:
                    self.draws += draws
        self.kept = []

    def params(self) -> List[Tuple[bool, torch.nn.Parameter]]:
        """Every encoder layer's trainable parameters, in one order on every
        rank, each with whether this stage runs its layer."""
        e = self.enhancer
        stacks = [m for m in (e.layers, e.text_layers, e.fusion_layers) if m is not None]
        return [(i in self.layers, p) for m in stacks for i in range(len(m))
                for p in m[i].parameters() if p.requires_grad]

    def _boundary(self, b: int, tensors, specs, forward: bool):
        group, lo, hi = self.mesh.boundaries[b]
        return _broadcast(group, lo if forward else hi, tensors, specs, self.device, "boundary")

    def _pipe_src(self, stage: int) -> int:
        return stage if self.group is None else tdist.get_global_rank(self.group, stage)

    def _run_layers(self, j, s, t, al, pos_j):
        rows = slice(j * self.bm, (j + 1) * self.bm)
        ref, kpm, tmask, tattn, pos_text = (None if x is None else x[rows] for x in self.fixed)
        feed = None if self.draws is None else MicrobatchMasks(self.draws, rows.start, rows.stop)
        for i in self.layers:
            s, t, a = self.enhancer.layer_step(i, s, t, pos_j, ref, self.spatial_shapes, kpm,
                                               tmask, tattn, pos_text, feed)
            al = al + a
        if feed is not None and feed.cursor != len(feed.draws):
            raise RuntimeError(f"a pipeline stage's layers drew {feed.cursor} masks of the "
                               f"{len(feed.draws)} that `pp._mask_shapes` plans")
        return s, t, al

    def forward(self, src, pos, text, keep: bool):
        """The forward schedule: (memory, text memory, adapter loss) on
        every pipe rank; with `keep`, each microbatch's graph is kept."""
        p, last = self.stage, self.n_pipe - 1
        specs = (self.src_spec, self.text_spec, ((), torch.float32))
        done = []
        for j in range(self.n_micro):
            rows = slice(j * self.bm, (j + 1) * self.bm)
            if p == 0:
                s_in, t_in = src[rows], text[rows]
                al = torch.zeros((), dtype=torch.float32, device=self.device)
            else:
                s_in, t_in, al = self._boundary(p - 1, None, specs, forward=True)
            pos_j = pos[rows]
            if keep:
                s_in = s_in.detach().requires_grad_(p > 0 or src.requires_grad)
                t_in = t_in.detach().requires_grad_(p > 0 or text.requires_grad)
                pos_j = pos_j.detach().requires_grad_(self.need_pos)
            with torch.enable_grad() if keep else contextlib.nullcontext():
                s, t, al = self._run_layers(j, s_in, t_in, al, pos_j)
            if keep:
                self.kept.append(((s_in, t_in, pos_j), (s, t, al)))
            if p < last:
                self._boundary(p, (s, t, al), specs, forward=True)
            else:
                done.append((s.detach(), t.detach(), al.detach()))
        whole = [self._whole(self.src_spec), self._whole(self.text_spec),
                 ((self.n_micro,), torch.float32)]
        mine = None
        if p == last:
            mine = [torch.cat([d[0] for d in done]), torch.cat([d[1] for d in done]),
                    torch.stack([d[2] for d in done])]
        memory, memory_text, als = _broadcast(self.group, self._pipe_src(last), mine, whole,
                                              self.device, "pipe")
        return memory, memory_text, als.mean()

    def _whole(self, spec):
        """A microbatch's spec at the whole local batch."""
        return (self.bm * self.n_micro,) + tuple(spec[0][1:]), spec[1]

    def backward(self, d_src, d_text, d_al, needs: Tuple[bool, bool, bool]):
        """The reverse schedule: ((d src, d pos, d text), every encoder
        layer's parameters' gradients, summed over the pipe line), the first
        three None where `needs` (src, pos, text) asks for no gradient."""
        p, last = self.stage, self.n_pipe - 1
        every = self.params()
        params = [q for own, q in every if own]
        d_params: List[Optional[torch.Tensor]] = [None] * len(params)
        names = ["src", "text"] + (["pos"] if self.need_pos else [])
        spec = {"src": self.src_spec, "text": self.text_spec, "pos": self.src_spec}
        specs = [spec[k] for k in names]
        d_in = {}
        if p == 0:
            d_in = {k: torch.zeros(self._whole(spec[k])[0], dtype=spec[k][1], device=self.device)
                    for k in names}
        d_al_j = d_al / self.n_micro
        for j in reversed(range(self.n_micro)):
            rows = slice(j * self.bm, (j + 1) * self.bm)
            (s_in, t_in, pos_j), outputs = self.kept[j]
            if p == last:
                got = {"src": d_src[rows], "text": d_text[rows]}
            else:
                got = dict(zip(names, self._boundary(p, None, specs, forward=False)))
            pairs = [(o, g) for o, g in zip(outputs, (got["src"], got["text"], d_al_j))
                     if o.requires_grad]
            inputs = {"src": s_in, "text": t_in, "pos": pos_j}
            wrt_names = [k for k in names if inputs[k].requires_grad]
            wrt = [inputs[k] for k in wrt_names] + params
            grads = [None] * len(wrt)
            if pairs and wrt:
                grads = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                            allow_unused=True)
            d = dict(zip(wrt_names, grads))
            for k, g in enumerate(grads[len(wrt_names):]):
                if g is not None:
                    d_params[k] = g if d_params[k] is None else d_params[k] + g
            send = [d[k] if d.get(k) is not None
                    else torch.zeros(spec[k][0], dtype=spec[k][1], device=self.device)
                    for k in names]
            if "pos" in got:  # d pos summed over the later stages
                send[2] = send[2] + got["pos"]
            if p > 0:
                self._boundary(p - 1, send, specs, forward=False)
            else:
                for k, g in zip(names, send):
                    d_in[k][rows] = g
        self.kept.clear()
        # stage 0's input gradients, to every pipe rank
        asked = [k for k, need in zip(("src", "pos", "text"), needs) if need and k in names]
        out = dict.fromkeys(("src", "pos", "text"))
        if asked:
            got = _broadcast(self.group, self._pipe_src(0), [d_in[k] for k in asked] if d_in
                             else None, [self._whole(spec[k]) for k in asked], self.device,
                             "pipe")
            out.update(zip(asked, got))
        return (out["src"], out["pos"], out["text"]), self._summed(every, d_params)

    def _summed(self, every, d_own) -> List[torch.Tensor]:
        """Every encoder layer's parameters' gradients summed over the pipe
        line: this stage's from `d_own` (zeros where the graph left one
        None), zeros for the other stages', one all-reduce per dtype."""
        if not every:
            return []
        mine = iter(d_own)
        local = []
        for own, q in every:
            g = next(mine) if own else None
            local.append(torch.zeros_like(q) if g is None else g)
        COUNTS["grads"] += 1
        out: List[Optional[torch.Tensor]] = [None] * len(local)
        for dtype in sorted({g.dtype for g in local}, key=str):
            idx = [k for k, g in enumerate(local) if g.dtype == dtype]
            flat = dist.reduced(torch.cat([local[k].reshape(-1) for k in idx]), self.group)
            for k, v in zip(idx, flat.split([local[k].numel() for k in idx])):
                out[k] = v.view_as(local[k])
        return out


class _GPipe(torch.autograd.Function):
    """The pipelined encoder as one autograd node: its inputs are src, pos,
    text, an anchor (a fresh leaf that makes the outputs ask for a
    gradient on every rank, so that every rank runs the backward's
    collectives) and every encoder layer's trainable parameters, whose
    gradients it returns summed over the pipe line, so that DDP's hooks
    see them as the backward makes them."""

    @staticmethod
    def forward(ctx, stage: _Stage, src, pos, text, anchor, *params):
        ctx.stage = stage
        return stage.forward(src, pos, text, keep=True)

    @staticmethod
    def backward(ctx, d_src, d_text, d_al):
        (g_src, g_pos, g_text), d_params = ctx.stage.backward(
            d_src, d_text, d_al, tuple(ctx.needs_input_grad[1:4]))
        ctx.stage = None
        return (None, g_src, g_pos, g_text, None, *d_params)


def pipelined_enhancer(enhancer, src, pos, reference_points, spatial_shapes, key_padding_mask,
                       text, text_token_mask, text_self_attention_masks, pos_text,
                       generator=None):
    """The encoder stack of `enhancer` (`models.transformer.FeatureEnhancer`)
    GPiped over the pipe axis of the active `pipeline_parallel`: (memory
    [B, S, E], text memory [B, T, E], adapter loss), the same on every pipe
    rank and equal to the loop's. `generator`: dropout's, or None."""
    if sp.active_mesh() is not None:
        raise AssertionError("sequence_parallel and pipeline_parallel are mutually exclusive "
                             "(they shard the same token activations)")
    mesh, m_req = active()
    n_pipe, n_layers = mesh.pipe, enhancer.cfg.enc_layers
    if n_layers % n_pipe:
        raise ValueError(f"enc_layers={n_layers} not divisible by pipe={n_pipe}")
    b = src.shape[0]
    n_micro = min(m_req or n_pipe, b)
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by microbatches={n_micro}")
    stage = _Stage(enhancer, mesh, n_micro, src, pos, text, reference_points, spatial_shapes,
                   key_padding_mask, text_token_mask, text_self_attention_masks, pos_text,
                   generator)
    # alike on every rank: the inputs are replicated and every rank holds
    # every layer
    train = torch.is_grad_enabled() and (
        any(t.requires_grad for t in (src, pos, text))
        or any(p.requires_grad for p in enhancer.parameters()))
    if not train:
        with torch.no_grad():
            return stage.forward(src, pos, text, keep=False)
    anchor = torch.zeros((), device=src.device, requires_grad=True)
    return _GPipe.apply(stage, src, pos, text, anchor, *(q for _, q in stage.params()))

