"""Loop labelling and ordering of the slice kernel vs a python walk.

The doubling path (ops/slicing._label_loops + _order_loop) must visit
exactly what a sequential walk of the successor map visits: loops in
order of their smallest compact index, each from that face in successor
direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shoulder_tpu.ops import slicing


def _py_walk(succ, crossed):
    k = len(succ)
    visited = np.zeros(k, bool)
    order, loop_id = [], []
    loop = -1
    for head in range(k):
        if not crossed[head]:
            break  # front-packed
        if visited[head]:
            continue
        loop += 1
        cur = head
        while not visited[cur]:
            visited[cur] = True
            order.append(cur)
            loop_id.append(loop)
            cur = succ[cur]
    return np.array(order), np.array(loop_id)


def _random_case(rng, k, n_loops, sizes):
    succ = np.arange(k, dtype=np.int32)
    crossed = np.zeros(k, np.int32)
    total = sum(sizes)
    perm = rng.permutation(total)  # faces 0..total-1 are crossed (packed)
    idx = 0
    for sz in sizes:
        loop = perm[idx:idx + sz]
        for a, b in zip(loop, np.roll(loop, -1)):
            succ[a] = b
        idx += sz
    crossed[:total] = 1
    return succ, crossed


def _doubling_walk(succ, crossed):
    """Visit order and loop ordinals from the doubling path's labels and
    per-loop ranks."""
    k = succ.shape[0]
    c = jnp.asarray(crossed, bool)
    s = jnp.asarray(succ)
    lab = np.asarray(slicing._label_loops(c, s))
    ids = jnp.stack([jnp.arange(k, dtype=jnp.float32),
                     jnp.zeros(k, jnp.float32)], axis=1)
    order, loop_id = [], []
    for li, head in enumerate(sorted(set(lab[np.asarray(crossed, bool)]))):
        n = int(np.sum(lab == head))
        pts = slicing._order_loop(c, ids, s, jnp.asarray(lab), head, n, k)
        order += np.asarray(pts)[:n, 0].astype(int).tolist()
        loop_id += [li] * n
    return np.array(order, int), np.array(loop_id, int)


@pytest.mark.parametrize("seed", range(4))
def test_chain_walk_matches_python(seed):
    rng = np.random.default_rng(seed)
    k = 128
    for case in range(6):
        n = rng.integers(1, 4)
        sizes = rng.integers(3, 30, size=n).tolist()
        while sum(sizes) > k - 4:
            sizes = sizes[:-1]
        succ, crossed = _random_case(rng, k, len(sizes), sizes)
        ref_order, ref_loop = _py_walk(succ, crossed)
        order, loop_id = _doubling_walk(succ, crossed)
        assert order.tolist() == ref_order.tolist(), f"case {case}"
        assert loop_id.tolist() == ref_loop.tolist(), f"case {case}"


def test_chain_walk_empty_slice():
    succ = np.arange(64, dtype=np.int32)
    crossed = np.zeros(64, np.int32)
    lab = np.asarray(slicing._label_loops(jnp.asarray(crossed, bool),
                                          jnp.asarray(succ)))
    assert (lab == 64).all()  # every face is uncrossed: the pad label
    order, _ = _doubling_walk(succ, crossed)
    assert order.size == 0


def test_chain_walk_vmap_batches_via_reshape():
    """Labels under vmap over a bone batch match the flat per-slice run."""
    rng = np.random.default_rng(7)
    k = 64
    cases = [_random_case(rng, k, 2, [5, 9]) for _ in range(6)]
    succ = np.stack([c[0] for c in cases]).reshape(2, 3, k)
    crossed = np.stack([c[1] for c in cases]).reshape(2, 3, k).astype(bool)

    f = jax.vmap(slicing._label_loops)
    lab_b = jax.vmap(f)(crossed, succ)
    lab_f = f(crossed.reshape(6, k), succ.reshape(6, k))
    assert np.array_equal(np.asarray(lab_b).reshape(6, k),
                          np.asarray(lab_f))
