"""The Jacobi pose head replayed as CUDA graphs.

`PoseMFShapeGaussianNet._head` with the Jacobi SVD is many small kernels a
forward at B = 72 (eight depth groups, each its MLP, one launch of the
svd3_jacobi kernel, properization and the mode; the concatenations and
stacks), and its autograd mirror as many again. The card does a few
microseconds of work per kernel; the host's launches are the cost. The head
draws nothing, syncs nothing and has fixed shapes for a batch, so its
launches are captured once and replayed: a forward graph (feats -> every
output) and, where grad is recorded, a backward graph (the outputs'
gradients -> the gradients of feats and of every parameter the head reads),
captured with torch.autograd.grad over the same ops in one memory pool with
its forward. A replay runs the same kernels on the same inputs as the eager
head, so it gives the same bits.

`GraphedHead.__call__(model, feats)` serves a call:

  * graphs only where feats is a CUDA tensor, the head is "jacobi" and no
    autocast is on; every other call is `model._head(feats)` as it is;
  * per model (held weakly) and per key (feats' shape, dtype and device,
    and whether grad is recorded): the key's first call runs eagerly (the
    warm-up, its results used as they are), the second captures and then
    replays, later calls replay;
  * a grad-mode call replays through one autograd Function, whose backward
    replays the backward graph and hands the parameters' gradients to
    autograd (AccumulateGrad fills .grad, so DDP's hooks and the optimizer
    see what they see eagerly); the parameters are read in place, so an
    optimizer's in-place updates need no new capture;
  * outputs and gradients are copied out of one packed static buffer each
    (one copy), so nothing a caller holds aliases graph memory;
  * a grad-mode call while the key's previous replay can still be
    backpropagated runs eagerly (a replay would overwrite the activations
    that backward reads): the replay's token, held by its autograd node,
    lives while the node does and is marked once its backward has run;
  * the graphs are captured again where a parameter or buffer the head
    reads has moved (its data_ptr), where a parameter's requires_grad, the
    head's settings or the deterministic-algorithms switch changed.

Counts: `replays` (calls served by a replay), `captures`, `eager` (CUDA
Jacobi calls run eagerly: warm-ups and guards), plain integers on the
instance, and the port's tracing counters `pose_head.graph_replays`,
`pose_head.graph_captures`, `pose_head.graph_eager` on the open span.
"""

import contextlib
import math
import weakref

import torch
from torch.autograd.function import once_differentiable

from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import count

# Packed tensors start ALIGN elements apart, where a fresh allocation would
# (the caching allocator's 512 bytes in float32), so a kernel reading them
# takes the path it takes on the eager head's outputs.
ALIGN = 128
# The head's outputs in the packed buffer; the shape's mean and log std go
# in as one (B, 2 x betas) block and come out as its two column slices, as
# `_head` returns them.
PACKED = ("pose_params_F", "pose_params_U", "pose_params_S", "pose_params_V",
          "pose_params_U_proper", "pose_params_S_proper", "pose_rotmats_mode",
          "glob", "cam")
SHAPE = ("shape_mean", "shape_log_std")


class CudaGraphs:
    """Where graphs apply and how they are captured: on the card."""

    def __init__(self):
        self.streams = {}           # device -> the side stream captures run on

    @staticmethod
    def applies(tensor):
        return tensor.is_cuda

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    def capture(self, fn, pool, device):
        """fn's launches recorded into a graph (not run), as torch.cuda.graph
        records them but without its gc.collect() and empty_cache(): the
        cache it empties is the train step's, which the next steps would
        allocate again.

        :return: the graph's replay, fn's result (its tensors the graph's
            static outputs)
        """
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        with torch.cuda.stream(self.streams[device]):
            # thread_local: another thread's CUDA calls (a loader's, NCCL's
            # watchdog) do not break the capture.
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph.replay, out


def _pack(tensors):
    """The tensors flattened into one buffer, each at a multiple of ALIGN."""
    pad = tensors[0].new_zeros(ALIGN)
    pieces = []
    for t in tensors:
        pieces += [t.reshape(-1), pad[:-t.numel() % ALIGN]]
    return torch.cat(pieces)


def _unpack(flat, shapes):
    """The tensors of `_pack`, as views of flat."""
    sizes = [math.prod(s) for s in shapes]
    chunks = flat.split([n for size in sizes for n in (size, -size % ALIGN)])
    return [c.view(s) for c, s in zip(chunks[::2], shapes)]


@contextlib.contextmanager
def _aliased(modules):
    """The modules' parameters swapped for leaves that share their storage
    while the block runs; yields those leaves, in `parameters()` order.

    A capture's autograd.grad then ends at leaves whose gradient
    accumulators are made on the capturing stream. A parameter's own
    accumulator is made on the stream of its first use, or by DDP at its
    construction, on the legacy default stream; feeding it from the
    capturing stream makes that stream wait on the capture, which CUDA
    refuses (cudaErrorStreamCaptureImplicit).
    """
    swapped = []
    for mod in (m for top in modules for m in top.modules()):
        for name, p in mod._parameters.items():
            if p is not None:
                swapped.append((mod, name, p))
                mod._parameters[name] = p.detach().requires_grad_(p.requires_grad)
    try:
        yield [mod._parameters[name] for mod, name, _ in swapped]
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class _Token:
    """One grad-mode replay: alive while its autograd node is, `done` once
    its backward has run."""

    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _Graphs:
    """One key's graphs, static tensors and layouts."""

    def __init__(self, signature, feats, forward, out, out_shapes, names,
                 backward=None, grad_out=None, grads=None, grad_shapes=None,
                 used=None):
        self.signature = signature
        self.feats = feats
        self.forward = forward
        self.out = out
        self.out_shapes = out_shapes
        self.names = names
        self.backward = backward
        self.grad_out = grad_out
        self.grads = grads
        self.grad_shapes = grad_shapes
        self.used = used
        self.last = None

    def pending(self):
        """Whether the last grad-mode replay can still be backpropagated."""
        token = self.last() if self.last is not None else None
        return token is not None and not token.done

    def run(self, feats):
        """feats in, the forward replayed, the packed outputs copied out."""
        self.feats.copy_(feats)
        self.forward()
        return self.out.clone()

    def run_backward(self, grad):
        """The packed outputs' gradient in, the backward replayed; the
        gradients of feats and each parameter (None where unused)."""
        self.grad_out.copy_(grad)
        self.backward()
        it = iter(_unpack(self.grads.clone(), self.grad_shapes))
        return [next(it) if u else None for u in self.used]

    def outputs(self, flat):
        """The head's dict, in `_head`'s order, from the packed outputs."""
        parts = _unpack(flat, self.out_shapes)
        out = dict(zip(PACKED, parts))
        shape = parts[-1]
        betas = shape.shape[1] // 2
        out[SHAPE[0]], out[SHAPE[1]] = shape[:, :betas], shape[:, betas:]
        return {k: out[k] for k in self.names}


class _Replay(torch.autograd.Function):
    """The forward graph as one autograd node whose backward is the
    backward graph. Inputs: the graphs, the replay's token, feats, the
    head's parameters; output: the packed outputs."""

    @staticmethod
    def forward(ctx, graphs, token, feats, *params):
        ctx.graphs, ctx.token = graphs, token
        return graphs.run(feats)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        graphs, token = ctx.graphs, ctx.token
        if token.done or graphs.last() is not token:
            raise RuntimeError("the graphed pose head's backward runs once a "
                               "forward (no retain_graph through it)")
        token.done = True
        grads = graphs.run_backward(grad)
        return (None, None) + tuple(g if need else None for g, need in
                                    zip(grads, ctx.needs_input_grad[2:]))


# A key whose first call has run eagerly and whose graphs are not captured.
_WARM = object()


class GraphedHead:
    """Serves PoseMFShapeGaussianNet's head; see the module docstring.

    :param graphs: where graphs apply and how they are captured (by
        default a CudaGraphs: on the card)
    """

    def __init__(self, graphs=None):
        self.graphs = CudaGraphs() if graphs is None else graphs
        self.models = weakref.WeakKeyDictionary()
        self.replays = self.captures = self.eager = 0

    def __call__(self, model, feats):
        if (model.svd_impl != "jacobi" or not self.graphs.applies(feats)
                or torch.is_autocast_enabled(feats.device.type)):
            return model._head(feats)
        params = model.head_parameters()
        grad = torch.is_grad_enabled() and (
            feats.requires_grad or any(p.requires_grad for p in params))
        key = (tuple(feats.shape), feats.dtype, feats.device, grad)
        keys = self.models.setdefault(model, {})
        graphs = keys.get(key)
        if graphs is None:
            keys[key] = _WARM
            return self._eager(model, feats)
        if graphs is not _WARM and grad and graphs.pending():
            return self._eager(model, feats)
        signature = self._signature(model, params)
        if graphs is _WARM or graphs.signature != signature:
            keys[key] = graphs = None      # the old graphs' memory goes first
            keys[key] = graphs = self._capture(model, feats, params, grad,
                                               signature)
            self.captures += 1
            count("pose_head.graph_captures")
        self.replays += 1
        count("pose_head.graph_replays")
        if not grad:
            return graphs.outputs(graphs.run(feats))
        token = _Token()
        graphs.last = weakref.ref(token)
        flat = _Replay.apply(graphs, token, feats, *params)
        return graphs.outputs(flat)

    def _eager(self, model, feats):
        self.eager += 1
        count("pose_head.graph_eager")
        return model._head(feats)

    @staticmethod
    def _signature(model, params):
        """What a capture fixes besides the key: where the tensors the head
        reads live, which parameters take gradients, the head's settings,
        the kernels' choice under deterministic algorithms."""
        return (tuple(t.data_ptr() for t in params + model.head_buffers()),
                tuple(p.requires_grad for p in params),
                (model.delta_i, model.delta_i_weight, model.svd_sweeps),
                torch.are_deterministic_algorithms_enabled())

    def _capture(self, model, feats, params, grad, signature):
        """The key's forward graph and, where grad is recorded, its backward
        graph, in one memory pool."""
        pool = self.graphs.pool()
        with torch.inference_mode(False):
            static_feats = torch.empty(feats.shape, dtype=feats.dtype,
                                       device=feats.device, requires_grad=grad)
        graph_out = {}

        def head():
            # Static tensors are plain tensors whatever the caller's mode.
            with torch.inference_mode(False), torch.set_grad_enabled(grad), \
                    _aliased(model.head_modules()) as aliases:
                out = model._head(static_feats)
                parts = ([out[k] for k in PACKED]
                         + [torch.cat([out[k] for k in SHAPE], dim=1)])
                graph_out.update(params=aliases, flat=_pack(parts), names=list(out),
                                 shapes=[tuple(t.shape) for t in parts])
            return graph_out["flat"]

        forward, out = self.graphs.capture(head, pool, feats.device)
        layout = (out.detach(), graph_out["shapes"], graph_out["names"])
        if not grad:
            return _Graphs(signature, static_feats, forward, *layout)
        needs = [True] + [p.requires_grad for p in params]
        grad_out = torch.zeros_like(out)
        found = {}

        def head_backward():
            inputs = [static_feats] + [p for p in graph_out["params"] if p.requires_grad]
            # On the capturing thread: from the engine's device thread the
            # same launches record slower (a process's first capture on an
            # H100: 8.8 s against 5.4 s).
            with torch.autograd.set_multithreading_enabled(False):
                grads = torch.autograd.grad(graph_out["flat"], inputs, grad_out,
                                            allow_unused=True)
            found["used"] = [g is not None for g in grads]
            found["shapes"] = [tuple(g.shape) for g in grads if g is not None]
            return _pack([g for g in grads if g is not None])

        backward, grads = self.graphs.capture(head_backward, pool, feats.device)
        it = iter(found["used"])
        used = [need and next(it) for need in needs]
        return _Graphs(signature, static_feats, forward, *layout, backward,
                       grad_out, grads, found["shapes"], used)


graphed_head = GraphedHead()
