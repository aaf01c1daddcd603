"""The port's replay ring (``selfplay/replay.py``) against the JAX package
on the CPU: priorities, stratified prioritized sampling with the JAX
package's uniform draws injected (indices exactly, importance weights at
1e-6), ``update_priority``, ``pop_until``, ``extract``, dataset files
(byte-identical, each package reading the other's) and quantization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu.selfplay import replay as jrb

from rebel_tpu_torch.selfplay import replay as rb

C, Q, H = 12, 5, 3


def rings(adds, alpha=1.0):
    """Both packages' rings after the same ``adds``: ``(rows, priority)``
    pairs, ``priority`` a scalar or one per row."""
    rng = np.random.RandomState(0)
    j = jrb.create(C, Q, H)
    p = rb.create(C, Q, H, device="cpu")
    for k, prio in adds:
        q = rng.randn(k, Q).astype(np.float32)
        v = rng.randn(k, H).astype(np.float32)
        j = jrb.add(j, jnp.asarray(q), jnp.asarray(v), jnp.asarray(prio),
                    alpha)
        rb.add(p, torch.as_tensor(q), torch.as_tensor(v),
               torch.as_tensor(prio), alpha)
    return j, p


def assert_same(p, j):
    assert (p.head, p.size, p.num_add) == (int(j.head), int(j.size),
                                           int(j.num_add))
    for f in ("queries", "values", "priorities"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


# Priorities whose cumulative sums are exact in float32 (alpha 0.5 of
# squares), so both packages invert the same sums.
PRIO = [(5, np.array([1.0, 4.0, 9.0, 16.0, 4.0], np.float32)),
        (4, np.float32(9.0)), (6, np.array([1, 4, 1, 16, 9, 4], np.float32))]


@pytest.mark.parametrize("adds", [PRIO[:1], PRIO[:2], PRIO],
                         ids=["partial", "nearly_full", "wrapped"])
def test_add_with_priorities_equals_jax(adds):
    j, p = rings(adds, alpha=0.5)
    assert_same(p, j)


@pytest.mark.parametrize("beta", [1.0, 0.4])
@pytest.mark.parametrize("n_adds", [1, 3], ids=["partial", "wrapped"])
def test_sample_prioritized_equals_jax(beta, n_adds):
    j, p = rings(PRIO[:n_adds], alpha=0.5)
    key = jax.random.PRNGKey(11)
    batch = 9
    want = jrb.sample_prioritized(j, key, batch, beta)
    u = jax.random.uniform(key, (batch,), maxval=1.0)  # the JAX draws
    got = rb.sample_prioritized(p, None, batch, beta,
                                u=torch.as_tensor(np.array(u)))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-6)
    np.testing.assert_array_equal(got.queries.numpy(),
                                  np.asarray(want.queries))
    drawn = rb.sample_prioritized(p, torch.Generator().manual_seed(0), 64,
                                  beta)
    assert (rb.valid_mask(p)[drawn.indices]).all()


def test_zero_priorities_get_zero_weight():
    """An empty ring and zero-priority slots: weights 0, never inf or
    NaN, as in the JAX package."""
    for adds in ([], [(4, np.array([0, 1, 0, 4], np.float32))]):
        j, p = rings(adds)
        key = jax.random.PRNGKey(2)
        want = jrb.sample_prioritized(j, key, 6, 1.0)
        got = rb.sample_prioritized(p, None, 6, 1.0, u=torch.as_tensor(
            np.array(jax.random.uniform(key, (6,)))))
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(got.weights.numpy(),
                                   np.asarray(want.weights), atol=1e-6)
        assert torch.isfinite(got.weights).all()
    assert rb.sample_uniform(rb.create(C, Q, H, "cpu"), None, 3
                             ).weights.sum() == 0


def test_update_priority_and_pop_until_equal_jax():
    j, p = rings(PRIO, alpha=0.5)
    idx = np.array([0, 5, 7])
    prio = np.array([25.0, 1.0, 0.0], np.float32)
    j = jrb.update_priority(j, jnp.asarray(idx), jnp.asarray(prio), 0.5)
    rb.update_priority(p, torch.as_tensor(idx), torch.as_tensor(prio), 0.5)
    assert_same(p, j)
    for n in (20, 7, 2):
        j = jrb.pop_until(j, n)
        rb.pop_until(p, n)
        assert_same(p, j)
        for a, b in zip(rb.extract(p), jrb.extract(j)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stride", [1, 2])
def test_dataset_files_are_byte_identical(tmp_path, stride):
    j, p = rings([(7, 1.0), (9, 1.0)])
    rb.save(p, tmp_path / "port.dat", stride=stride)
    jrb.save(j, str(tmp_path / "jax.dat"), stride=stride)
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()
    for path in ("port.dat", "jax.dat"):
        a = rb.load_file(tmp_path / path, max_size=5)
        b = jrb.load_file(str(tmp_path / path), max_size=5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # Preloading the JAX package's file gives both rings the same rows.
    j2 = jrb.load_into(jrb.create(C, Q, H), str(tmp_path / "jax.dat"))
    p2 = rb.load_into(rb.create(C, Q, H, "cpu"), tmp_path / "jax.dat")
    assert_same(p2, j2)
    (tmp_path / "empty.dat").write_bytes(b"")
    with pytest.raises(ValueError, match="no rows"):
        rb.load_file(tmp_path / "empty.dat")


def test_quantize_equals_jax():
    x = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    got = rb.quantize(torch.as_tensor(x))
    want = jrb.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rb.dequantize(got).numpy(),
                                  np.asarray(jrb.dequantize(want)))
