"""Mesh with a "replica" axis (independent device groups): own file so
the xdist worker doesn't stack it on top of the other 8-device engines
(late heavy compiles in one long-lived XLA:CPU process are unstable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.parallel import make_mesh

CTX = ("Sharded caches should behave identically. " * 30 +
       "The secret word is zanzibar. " +
       "Filler sentence for the long tail of the context. " * 20)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_replica_dcn_mesh_matches_single_device():
    """Multi-slice layout: ("replica","data","model") mesh with replica as
    the major (DCN) axis. Weights/caches replicate per slice (specs omit
    "replica"); the whole pipeline matches the unsharded engine, and batched
    serving shards the batch over ("replica","data")."""
    from kvzip_tpu.serving import batched_generate

    cfg = tiny_config("llama")  # 8 q heads, 4 kv heads

    def build(mesh):
        return Engine("tiny-llama", kv_type="evict", config=cfg,
                      dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                      capacity_granularity=256, score_chunk_size=256,
                      mesh=mesh, seed=11, flat_decode="off")

    ref = build(None)
    st_ref = ref.prefill(CTX, prefill_chunk_size=300)

    mesh = make_mesh(8, tp=2, replicas=2)  # (replica=2, data=2, model=2)
    assert mesh.axis_names == ("replica", "data", "model")
    eng = build(mesh)
    st = eng.prefill(CTX, prefill_chunk_size=300)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)

    ref.prune(st_ref, 0.5, "pair")
    eng.prune(st, 0.5, "pair")
    q = eng.apply_template("What is the secret word?")
    p = eng.prob(q, st)
    p_ref = ref.prob(q, st_ref)
    np.testing.assert_allclose(p, p_ref, atol=3e-3, rtol=0)

    # batched serving: 4 requests shard over replica*data = 4 DP shards
    ctxs = [CTX, CTX[40:], CTX[80:], CTX[117:]]
    states = [eng.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for s in states:
        eng.prune(s, 0.5, "pair")
    outs = batched_generate(eng, [q] * 4, states, max_new_tokens=5)
    states_ref = [ref.prefill(c, prefill_chunk_size=300) for c in ctxs]
    for s in states_ref:
        ref.prune(s, 0.5, "pair")
    want = [ref.generate(q, s, max_new_tokens=5) for s in states_ref]
    assert outs == want
