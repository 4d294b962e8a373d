"""The bodies that cudagaussianrenderer_torch.tools.measure times, on the CPU:
its sort, gather and reorder bodies against NumPy at the JAX smoke's
capacity of 131,072 (distinct keys, so the sorted order is unique and the
comparison exact), and its count matrix + row cumsum against the JAX tool's
body (tools/measure.py:496-505, written out here in jax.numpy: importing
the JAX tool would reconfigure this process's compilation cache) within
float32 1e-6 relative.  The probes held against the JAX package are in
test_torch_measure_probes.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch.tools import measure

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

CAP = 131_072


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    key = rng.permutation(CAP).astype(np.int32) * 4 + 1  # distinct, below 2^31
    words = [rng.integers(0, 1 << 32, CAP, dtype=np.uint32).view(np.int32) for _ in range(3)]
    return key, words


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("words", [0, 1, 2, 3])
def test_flat_sort_sorts_keys_and_carries_payloads(data, words):
    key, payloads = data
    order = np.argsort(key)
    got_key, got = measure.sort_flat(t(key), [t(p) for p in payloads[:words]])
    np.testing.assert_array_equal(got_key.numpy(), key[order])
    assert len(got) == words
    for g, p in zip(got, payloads):
        np.testing.assert_array_equal(g.numpy(), p[order])


@pytest.mark.parametrize("g", [8, 16, 32, 64, 128])
def test_batched_sort_sorts_each_row(data, g):
    key, payloads = data
    k2 = key.reshape(g, -1)
    order = np.argsort(k2, axis=1)
    got_key, got = measure.sort_batched(t(key), [t(p) for p in payloads], g)
    np.testing.assert_array_equal(got_key.numpy().reshape(g, -1),
                                  np.take_along_axis(k2, order, 1))
    for gp, p in zip(got, payloads):
        np.testing.assert_array_equal(gp.numpy().reshape(g, -1),
                                      np.take_along_axis(p.reshape(g, -1), order, 1))


def test_gather_bodies_match_numpy(data):
    key, payloads = data
    order = np.argsort(key)
    values, index = measure.sort_key_index(t(key))
    assert values.dtype == torch.int64
    np.testing.assert_array_equal(values.numpy(), key[order].astype(np.int64))
    np.testing.assert_array_equal(index.numpy(), order)

    perm = np.random.default_rng(1).permutation(CAP)
    for g, p in zip(measure.gather_rows(t(perm), [t(p) for p in payloads]), payloads):
        np.testing.assert_array_equal(g.numpy(), p[perm])

    sk, rows = measure.sort_gather_stacked(t(key), torch.stack([t(p) for p in payloads]))
    np.testing.assert_array_equal(sk.numpy(), key[order])
    np.testing.assert_array_equal(rows.numpy(), np.stack(payloads)[:, order])

    sk32, got = measure.sort_i32(t(key), [t(p) for p in payloads])
    assert sk32.dtype == torch.int32
    np.testing.assert_array_equal(sk32.numpy(), key[order])
    for g, p in zip(got, payloads):
        np.testing.assert_array_equal(g.numpy(), p[order])


def test_sort_inputs_are_the_jax_tools_draws():
    """The key below 2^31 and the payload words are the JAX tool's
    default_rng(0) draws (uint32 there, their bit patterns here)."""
    key, payloads, _ = measure.sort_keys_and_payloads(4096, torch.device("cpu"))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(key.numpy(), rng.integers(0, 1 << 31, 4096, dtype=np.uint32))
    for p in payloads:
        np.testing.assert_array_equal(p.numpy().view(np.uint32),
                                      rng.integers(0, 1 << 32, 4096, dtype=np.uint32))


def test_reorder_sort_carries_every_column():
    n = 65_536
    rng = np.random.default_rng(2)
    band = rng.permutation(n).astype(np.int64)
    cols = [rng.random(n, dtype=np.float32) for _ in range(6)]
    cols += [rng.integers(0, 1 << 32, n, dtype=np.uint32).view(np.int32) for _ in range(2)]
    order = np.argsort(band)
    sk, got = measure.reorder_sort(t(band), [t(c) for c in cols])
    np.testing.assert_array_equal(sk.numpy(), band[order])
    for g, c in zip(got, cols):
        np.testing.assert_array_equal(g.numpy(), c[order])


def jax_count_matrix(c, y, g, s):
    """The JAX tool's body_cnt before its final sum."""
    rows_per = 64 // g
    bids = jnp.floor(y / rows_per)
    mat = jnp.stack([jnp.where(bids == float(b), c + s * 1e-9, 0.0) for b in range(g)])
    return jnp.cumsum(mat, axis=1)


@pytest.mark.parametrize("g", [8, 16, 32, 64])
def test_count_matrix_cumsum_matches_the_jax_body(g):
    n = 65_536
    _, _, counts, y0 = measure.reorder_inputs(n, torch.device("cpu"))
    for s in (0.0, 3.0):
        got = measure.count_matrix_cumsum(counts, y0, g, s).numpy()
        want = np.asarray(jax_count_matrix(jnp.asarray(counts.numpy()),
                                           jnp.asarray(y0.numpy()), g, jnp.float32(s)))
        assert got.shape == want.shape == (g, n) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert want[:, -1].sum() > 0


def test_probe_capacity_rule():
    assert measure.capacity_for(1000, 1.02) == 1024
    assert measure.capacity_for(3_656_939, 1.005) == -(-int(3_656_939 * 1.005) // 1024) * 1024
    assert measure.capacity_for(2048, 1.0) == 2048
    assert measure.compact_capacity_for(1_003_520, 16) == 3_014_656


def test_harness_records_a_failed_line_and_carries_on(capsys):
    h = measure.Harness(torch.device("cpu"), reps=2)
    h.dispatch_baseline()

    def broken(s, x):
        raise ValueError("boom")

    assert h.timed("broken body", broken, torch.ones(4)) is None
    ms = h.timed("good body", lambda s, x: torch.sum(x) + s, torch.ones(4))
    assert ms is not None and ms >= 0
    assert h.failed == ["broken body"]
    out = capsys.readouterr().out
    assert "broken body" in out and "FAILED: ValueError: boom" in out
    good = h.lines[-1]
    assert good["method"] == "eager" and good["device_ms"] is None and good["net_ms"] is not None


def test_a_failed_line_makes_the_exit_code_one(monkeypatch, capsys):
    def broken(h, capacity):
        h.timed("broken", lambda s: 1 / 0)
        return {}

    monkeypatch.setattr(measure, "cmd_sort", broken)
    assert measure.main(["sort", "--device", "cpu", "--capacity", "4096"]) == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"failed": ["broken"]' in line and '"device": "cpu"' in line
