"""Each traffic mix's inputs come from the seed alone: a second draw with
the same seed gives the same tensors and order, another seed others."""

import pytest
import torch

from pcclbench import harness

SEED = 2**31 + 7


def draw(tiny, workload, seed):
    _, _, _, runner = harness.make_cell(harness.ROOT, workload, seed, torch.device("cpu"), False,
                                        tiny[workload])
    runner.inputs()
    return runner


def tensors(runner):
    if hasattr(runner, "xms"):
        return runner.xs + runner.xms + [runner.w, runner.gamma]
    return [t for sets in (runner.xs, runner.shards) for s in sets for t in s.values()]


@pytest.mark.parametrize("workload", ["mistral123b-tp8.layer", "mistral123b-tp8.colls"])
def test_inputs_repeat_for_a_seed(tiny, workload):
    a, b, c = draw(tiny, workload, SEED), draw(tiny, workload, SEED), draw(tiny, workload, SEED + 1)
    assert all(torch.equal(u, v) for u, v in zip(tensors(a), tensors(b)))
    assert not any(torch.equal(u, v) for u, v in zip(tensors(a), tensors(c)))


def test_collective_order_repeats_and_keeps_its_calls(tiny):
    w = "mistral123b-tp8.colls"
    a, b, c = (draw(tiny, w, s) for s in (SEED, SEED, SEED + 1))
    orders = [[tuple(d.pairs[i]) for i in d.rng.permutation(len(d.pairs))] for d in (a, b, c)]
    assert orders[0] == orders[1] and a.checked == b.checked
    # every seed gets the same set of calls, in another order
    assert sorted(orders[0]) == sorted(orders[2]) == sorted(map(tuple, a.pairs))
    assert orders[0] != orders[2]
