"""The numbers that decide `correct`: gaps between what the timed path
produced and what the reference computes from the same inputs. Each is a
relative gap, 0 for equal values; the cell's workload file gives each its
limit. How each limit was set from its two readings is in PERF.md.
"""

import math
import statistics

import torch

# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone, and are left out of the change.
STILL_LEAF_SHARE = 1e-3


def loss_gap(losses, ref_losses):
    """The largest |loss - ref| / |ref| over the steps both ran."""
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(losses, ref_losses))


def leaf_gap(norms, ref_norms, leaves=None):
    """The worst leaf's gap between two norms: |norm - ref| over the larger
    of the reference leaf's norm and the median leaf's (some gradients are
    all but zero).

    :param norms, ref_norms: {leaf: norm}
    :param leaves: the leaves compared (default: all)
    :return: (gap, leaf)
    """
    leaves = sorted(ref_norms) if leaves is None else sorted(leaves)
    median = statistics.median(ref_norms[k] for k in ref_norms)
    worst, at = 0.0, None
    for k in leaves:
        gap = abs(norms[k] - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(ref_grad_norms):
    """The leaves whose reference gradient is at least STILL_LEAF_SHARE of
    the median leaf's."""
    median = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= STILL_LEAF_SHARE * median]


def train_numbers(got, ref):
    """The three numbers of a training cell, and what they leave out.

    Compared: the first step's loss (`loss1_gap`); the first gradient by
    its worst leaf (`grad_gap`); the parameters' change after the steps by
    the median leaf's gap (`change_gap`), over the leaves that move. The
    later steps' losses, the worst leaf's change and the whole model's
    change are reported (`_info`) and not compared: the float32 step's
    atomics make them differ between two runs of the same code on the same
    inputs (the worst leaf by up to 0.17), and under deterministic
    algorithms the port and the reference agree bit for bit; PERF.md gives
    the readings.

    :param got, ref: dicts losses [float], grad_norms {leaf: float} (the
        first gradient, from Adam's state after step 1), change_norms
        {leaf: float} (|params after the steps - params before|)
    """
    grad, grad_leaf = leaf_gap(got["grad_norms"], ref["grad_norms"])
    moving = moving_leaves(ref["grad_norms"])
    change = statistics.median(
        abs(got["change_norms"][k] - ref["change_norms"][k])
        / max(ref["change_norms"][k], 1e-30) for k in moving)
    worst_change, change_leaf = leaf_gap(got["change_norms"], ref["change_norms"],
                                         moving)
    return {"loss1_gap": loss_gap(got["losses"][:1], ref["losses"][:1]),
            "grad_gap": grad, "change_gap": change,
            "_info": {"grad_gap worst leaf": grad_leaf,
                      "loss_gap over all steps": loss_gap(got["losses"], ref["losses"]),
                      "change_gap worst leaf": f"{worst_change!r} at {change_leaf}",
                      "change_gap whole model": whole_gap(got["change_norms"],
                                                          ref["change_norms"]),
                      "leaves compared in change_gap":
                          f"{len(moving)} of {len(ref['grad_norms'])}"}}


def whole_gap(norms, ref_norms):
    """|norm - ref| / ref of the whole model, from its leaves' norms."""
    whole = math.sqrt(sum(v * v for v in norms.values()))
    ref_whole = math.sqrt(sum(v * v for v in ref_norms.values()))
    return abs(whole - ref_whole) / max(ref_whole, 1e-30)


def output_gap(got, ref):
    """The widest relative gap over a set of outputs: per output name, the
    largest |got - ref| over the largest |ref| of that output.

    :param got, ref: {name: tensor}
    :return: (gap, name)
    """
    worst, at = 0.0, None
    for name in sorted(ref):
        r = ref[name].double()
        g = got[name].double().to(r.device)
        if g.shape != r.shape:
            return math.inf, name
        scale = float(r.abs().max())
        gap = float((g - r).abs().max()) / max(scale, 1e-30)
        if not math.isfinite(gap):
            return math.inf, name
        if gap >= worst:
            worst, at = gap, name
    return worst, at


def judge(numbers, limits):
    """(correct, lines): each number beside its limit; a number that is not
    finite, or has no limit, fails."""
    ok, lines = True, []
    for name in sorted(limits):
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limits[name]
        ok = ok and good
        lines.append(f"{name} {value!r} limit {limits[name]!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines


@torch.no_grad()
def param_norms(named, reference=None):
    """{leaf: norm} of tensors, or of their difference from `reference`."""
    out = {}
    for k, t in named.items():
        d = t.double() if reference is None else t.double() - reference[k].double()
        out[k] = float(torch.linalg.vector_norm(d))
    return out
