"""The Jacobi pose head as CUDA graphs (models/graphed_head.py).

On the CPU (no card): a CPU head and a LAPACK-sign head never reach the
graphs and return what `_head` returns; with a stand-in for the capture
(`StandIn`: the captured function runs again at each replay, its results
copied into the first run's tensors, as a graph writes its static
outputs), the wrapper's own logic: warm-up, capture and replay, bit-equal
to the eager head in outputs and gradients; a new capture where a
parameter moves; the eager path for a second forward before the backward;
outputs that no later call changes; the no-grad graphs.

On the card (`cuda`, skipped elsewhere), run there with

    python -m pytest --noconftest -m cuda tests/test_torch_graphed_head.py

the real graphs: bit-equal to the eager head at B = 72 with the three
encoders' feature widths and at B = 8 under inference_mode; a training
trajectory through TrainStep, eager against graphed, under deterministic
algorithms; the second-forward guard.
"""

import contextlib

import pytest
import torch

from hierarchicalprobabilistic3dhuman_torch.models import graphed_head as gh
from hierarchicalprobabilistic3dhuman_torch.models import pose_mf_shape_gaussian_net as pmf
from hierarchicalprobabilistic3dhuman_torch.models import vit
from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights

torch.set_num_threads(2)


class StandIn:
    """Capture on the CPU: fn runs at capture and again at every replay,
    each later result copied into the first's tensors."""

    applies = staticmethod(lambda tensor: True)
    pool = staticmethod(lambda: None)

    @staticmethod
    def capture(fn, pool, device):
        out = fn()

        def replay():
            new = fn()
            with torch.no_grad():
                out.copy_(new)
        return replay, out


class NoGraphs(gh.CudaGraphs):
    """The card's capture, never applied: every call is the eager head."""

    applies = staticmethod(lambda tensor: False)


def predictor(width=512, embed_dim=256, seed=0, device="cpu", monkeypatch=None):
    """A predictor whose head reads `width` features (512: ResNet-18,
    2048: ResNet-50, 1280: ViT-H/16, one block of it), weights from `seed`."""
    if width == 1280:
        monkeypatch.setattr(vit, "VIT_H", dict(vit.VIT_H, depth=1))
        model = pmf.PoseMFShapeGaussianNet(encoder="vit_h", embed_dim=embed_dim)
    else:
        model = pmf.PoseMFShapeGaussianNet(
            num_resnet_layers={512: 18, 2048: 50}[width], embed_dim=embed_dim)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():            # biases too, so no term is trivially 0
        gen = torch.Generator().manual_seed(seed + 1)
        for p in model.head_parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    assert model.image_encoder.num_features == width
    return model.to(device)


def feats_of(B, width, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, width, generator=gen).to(device)


def head_step(head, model, feats, seed=7):
    """One call of `head` on a fresh leaf copy of feats, then a backward of
    a seeded weighted sum of every output.

    :return: outputs (detached), feats' gradient, {parameter: gradient}
    """
    f = feats.clone().requires_grad_(True)
    out = head(f)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=gen).to(o.device)).sum()
               for o in out.values())
    model.zero_grad(set_to_none=True)
    loss.backward()
    return ({k: v.detach() for k, v in out.items()}, f.grad,
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None})


def assert_same(a, b):
    """Two head_step results bit for bit: outputs (and their strides),
    feats' gradient, every parameter's gradient."""
    (out_a, fa, ga), (out_b, fb, gb) = a, b
    assert list(out_a) == list(out_b)
    for k in out_a:
        assert out_a[k].stride() == out_b[k].stride(), k
        assert torch.equal(out_a[k], out_b[k]), k
    assert torch.equal(fa, fb)
    assert sorted(ga) == sorted(gb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def counts(head):
    return head.eager, head.captures, head.replays


@pytest.fixture(scope="module")
def small():
    """A small predictor on the CPU (its head at EMBED_DIM 32)."""
    return predictor(embed_dim=32)


def test_cpu_and_lapack_heads_never_reach_the_graphs(small):
    """The card's wrapper on CPU tensors, and any wrapper on a LAPACK-sign
    head or under autocast, is `_head` itself: same bits, nothing counted."""
    feats = feats_of(3, 512, 1)
    head = gh.GraphedHead()
    for _ in range(3):
        assert_same(head_step(small._head, small, feats),
                    head_step(lambda f: head(small, f), small, feats))
    assert counts(head) == (0, 0, 0) and small not in head.models
    stand_in = gh.GraphedHead(StandIn)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        for _ in range(2):
            stand_in(small, feats)
    lapack = predictor(embed_dim=32)
    lapack.svd_impl = "lapack"
    with torch.no_grad():
        for _ in range(3):
            out, ref = stand_in(lapack, feats), lapack._head(feats)
            assert all(torch.equal(out[k], ref[k]) for k in ref)
    assert counts(stand_in) == (0, 0, 0) and not stand_in.models


def test_warm_up_capture_replay_bit_equal(small):
    """The key's first call eager, the second captured and replayed, later
    ones replayed: every one bit-equal to `_head` in outputs and gradients;
    another batch size is another key."""
    head = gh.GraphedHead(StandIn)
    for i, (B, want) in enumerate([(3, (1, 0, 0)), (3, (1, 1, 1)), (3, (1, 1, 2)),
                                   (2, (2, 1, 2)), (2, (2, 2, 3))]):
        feats = feats_of(B, 512, 10 + i)
        assert_same(head_step(small._head, small, feats, seed=i),
                    head_step(lambda f: head(small, f), small, feats, seed=i))
        assert counts(head) == want


def test_moved_parameter_recaptures(small):
    """A parameter or buffer at a new address (a `.to()`, a checkpoint
    swapped in), a parameter frozen, or the deterministic switch: the next
    call captures again and reads the new tensors."""
    model = predictor(embed_dim=32)
    head = gh.GraphedHead(StandIn)
    feats = feats_of(2, 512, 3)
    for _ in range(2):
        head(model, feats)
    assert counts(head) == (1, 1, 1)
    head(model, feats)
    assert counts(head) == (1, 1, 2)
    with torch.no_grad():
        model.fc_pose[5][2].weight.data = model.fc_pose[5][2].weight.data * 2
    assert_same(head_step(model._head, model, feats),
                head_step(lambda f: head(model, f), model, feats))
    assert counts(head) == (1, 2, 3)
    model.init_cam.data = model.init_cam.data + 1
    head_step(lambda f: head(model, f), model, feats)
    assert counts(head) == (1, 3, 4)
    model.fc1.bias.requires_grad_(False)
    out = head_step(lambda f: head(model, f), model, feats)
    assert counts(head) == (1, 4, 5) and "fc1.bias" not in out[2]
    assert_same(head_step(model._head, model, feats), out)
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        head_step(lambda f: head(model, f), model, feats)
    finally:
        torch.use_deterministic_algorithms(previous)
    assert counts(head) == (1, 5, 6)


def test_second_forward_before_backward_runs_eagerly(small):
    """While a replay can still be backpropagated, the next grad-mode call
    runs eagerly (counted); outputs handed out are never changed by a later
    call; a backward or lost outputs free the graphs again, and a second
    backward through one replay raises."""
    head = gh.GraphedHead(StandIn)
    fa, fb = feats_of(2, 512, 4), feats_of(2, 512, 5)
    for _ in range(2):
        head(small, fa)
    f1 = fa.clone().requires_grad_(True)
    out1 = head(small, f1)
    kept = {k: v.detach().clone() for k, v in out1.items()}
    assert counts(head) == (1, 1, 2)
    out2 = head(small, fb.clone().requires_grad_(True))
    assert counts(head) == (2, 1, 2)
    assert all(torch.equal(out1[k], kept[k]) for k in kept)
    loss = sum(o.sum() for o in out1.values())
    loss.backward(retain_graph=True)
    ref = fa.clone().requires_grad_(True)
    sum(o.sum() for o in small._head(ref).values()).backward()
    assert torch.equal(f1.grad, ref.grad)
    with pytest.raises(RuntimeError, match="runs once a forward"):
        loss.backward()
    out3 = head(small, fb)                  # after the backward: a replay
    assert counts(head) == (2, 1, 3)
    assert all(torch.equal(out3[k], out2[k]) for k in out2)
    assert all(torch.equal(out1[k], kept[k]) for k in kept)
    del out3                                 # a lost backward frees them too
    head(small, fa.clone().requires_grad_(True))
    assert counts(head) == (2, 1, 4)


def test_no_grad_graphs(small):
    """Calls under no_grad and inference_mode share their own graphs, apart
    from grad mode's, and give `_head`'s bits."""
    head = gh.GraphedHead(StandIn)
    feats = feats_of(2, 512, 6)
    for mode, want in ((torch.no_grad, (1, 0, 0)), (torch.inference_mode, (1, 1, 1)),
                       (torch.no_grad, (1, 1, 2))):
        with mode():
            out, ref = head(small, feats), small._head(feats)
        assert list(out) == list(ref)
        assert all(torch.equal(out[k], ref[k]) for k in ref)
        assert counts(head) == want
    head_step(lambda f: head(small, f), small, feats)
    assert counts(head) == (2, 1, 2)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@contextlib.contextmanager
def eager_heads(monkeypatch):
    """Every predictor's forward through a wrapper that never graphs."""
    with monkeypatch.context() as m:
        m.setattr(pmf, "graphed_head", gh.GraphedHead(NoGraphs()))
        yield


@pytest.mark.cuda
@pytest.mark.parametrize("width", [512, 2048, 1280])
def test_graphs_bit_equal_to_eager_head_on_card(cuda_device, width, monkeypatch):
    """At B = 72 with each encoder's feature width: the warm-up, the
    captured call and two replays, each against `_head` on the same feats
    and output gradients: outputs, feats' gradient and every head
    parameter's gradient bit for bit."""
    model = predictor(width, device=cuda_device, monkeypatch=monkeypatch)
    head = gh.GraphedHead()
    with pmf.full_f32_matmul():
        for i in range(4):
            feats = feats_of(72, width, 20 + i, cuda_device)
            assert_same(head_step(model._head, model, feats, seed=i),
                        head_step(lambda f: head(model, f), model, feats, seed=i))
    assert counts(head) == (1, 1, 3)


@pytest.mark.cuda
def test_inference_mode_graphs_bit_equal_on_card(cuda_device):
    """B = 8 under inference_mode (the predict core's calls)."""
    model = predictor(device=cuda_device).eval()
    head = gh.GraphedHead()
    with pmf.full_f32_matmul(), torch.inference_mode():
        for i in range(4):
            feats = feats_of(8, 512, 30 + i, cuda_device)
            out, ref = head(model, feats), model._head(feats)
            assert all(torch.equal(out[k], ref[k]) for k in ref)
    assert counts(head) == (1, 1, 3)


@pytest.mark.cuda
def test_second_forward_before_backward_on_card(cuda_device):
    """The guard on the card: a second grad-mode call before the backward
    runs eagerly, call 1's outputs unchanged by call 2, call 1's gradients
    those of `_head`."""
    model = predictor(device=cuda_device)
    head = gh.GraphedHead()
    fa, fb = feats_of(72, 512, 40, cuda_device), feats_of(72, 512, 41, cuda_device)
    with pmf.full_f32_matmul():
        for _ in range(2):
            head(model, fa)
        f1 = fa.clone().requires_grad_(True)
        out1 = head(model, f1)
        kept = {k: v.detach().clone() for k, v in out1.items()}
        head(model, fb.clone().requires_grad_(True))
        assert counts(head) == (2, 1, 2)
        assert all(torch.equal(out1[k], kept[k]) for k in kept)
        sum(o.sum() for o in out1.values()).backward()
        ref = fa.clone().requires_grad_(True)
        sum(o.sum() for o in model._head(ref).values()).backward()
    assert torch.equal(f1.grad, ref.grad)


@pytest.mark.cuda
def test_graphs_beside_held_gradient_accumulators_on_card(cuda_device):
    """Parameters whose gradient accumulators were made on the default
    stream and are held (as DDP's reducer holds them from its construction):
    the capture does not touch them, and their hooks see the replay's
    gradients, bit-equal to the eager head's."""
    model = predictor(device=cuda_device)
    accumulators = [p.view_as(p).grad_fn.next_functions[0][0]
                    for p in model.head_parameters()]
    seen = []
    for acc in accumulators:
        acc.register_hook(lambda grad_in, grad_out: seen.append(1))
    head = gh.GraphedHead()
    with pmf.full_f32_matmul():
        for i in range(3):
            feats = feats_of(72, 512, 50 + i, cuda_device)
            seen.clear()
            assert_same(head_step(model._head, model, feats, seed=i),
                        head_step(lambda f: head(model, f), model, feats, seed=i))
            assert len(seen) == 2 * len(accumulators)
    assert counts(head) == (1, 1, 2)


@pytest.mark.cuda
def test_training_trajectory_bit_equal_eager_and_graphed(cuda_device, monkeypatch):
    """chip_smoke's trajectory at B = 72, 256^2 (ResNet-18, 4 Adam steps of
    loss stage 1 then 4 of stage 2, one model and Adam), under
    deterministic algorithms: eager heads against graphed heads, every
    step's loss, terms and sums, BatchNorm statistics, and the final
    parameters and Adam state bit for bit."""
    import chip_smoke
    cfg = chip_smoke.golden_cfg()
    batches = chip_smoke.golden_full_batches(cuda_device, cfg)
    runs = {}
    with chip_smoke.deterministic_algorithms():
        with eager_heads(monkeypatch):
            runs["eager"], _ = chip_smoke.golden_trajectory(cuda_device, cfg, batches)
        before = counts(pmf.graphed_head)
        runs["graphed"], _ = chip_smoke.golden_trajectory(cuda_device, cfg, batches)
    eager, captures, replays = (a - b for a, b in zip(counts(pmf.graphed_head), before))
    assert (eager, captures) == (1, 1) and replays == 2 * chip_smoke.GOLDEN_STEPS - 1
    assert chip_smoke.same_trajectory(runs["eager"], runs["graphed"])
