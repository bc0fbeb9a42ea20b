"""Tensor-parallel POOL decode (parallel/pool_tp.py) vs single device.

The flagship pool decode path must work under the mesh.
8 virtual CPU devices (conftest); per-shard pools built at prune, decode
through shard_mapped pool kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine

CTX = ("Relay four reported beacon 7731 offline; the Peregrine rerouted "
       "through sector nine carrying medical cargo. " * 12)


def _engine(mesh, kv_quant, params=None, tokenizer=None):
    cfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                      hidden_size=128)
    return Engine("tiny-llama", kv_type="evict", config=cfg,
                  dtype=jnp.float32, max_new_tokens=6, decode_budget=256,
                  capacity_granularity=256, score_chunk_size=256,
                  flat_decode="on", kv_quant=kv_quant, mesh=mesh,
                  params=params, tokenizer=tokenizer, seed=3)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
@pytest.mark.parametrize("kv_quant", ["none", "int4"])
@pytest.mark.parametrize("level", ["pair", "head"])
def test_pool_tp_decode_matches_single_device(kv_quant, level):
    from kvzip_tpu.parallel import make_mesh
    from kvzip_tpu.pool import PoolInt4KV, PoolKV

    ref = _engine(None, kv_quant)
    st_ref = ref.prefill(CTX, prefill_chunk_size=200)

    mesh = make_mesh(4, tp=2)
    eng = _engine(mesh, kv_quant, params=ref.params,
                  tokenizer=ref.tokenizer)
    st = eng.prefill(CTX, prefill_chunk_size=200)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(st.score)),
        np.asarray(jax.device_get(st_ref.score)), rtol=2e-4, atol=2e-4)

    if level == "head":
        # context-independent head scores, like load_head_score
        L, H = eng.config.num_layers, eng.config.num_kv_heads
        hs = np.linspace(0.1, 1.0, L * H, dtype=np.float32).reshape(L, H)
        for s in (st, st_ref):
            s.score = jnp.asarray(
                np.broadcast_to(hs[:, :, None], (L, H, s.ctx_len)))
    ref.prune(st_ref, 0.5, level)
    eng.prune(st, 0.5, level)

    pool = st.cache
    assert isinstance(pool, (PoolKV, PoolInt4KV))
    assert pool.tp == 2 and pool.layer_off.shape[0] == 2
    # per-shard kept rows agree with the single-device plan's totals
    assert int(jax.device_get(pool.lengths).sum()) == \
        int(jax.device_get(st_ref.cache.lengths).sum())

    q = eng.apply_template("Which beacon went offline?")
    out_tp = eng.generate(q, st)
    out_ref = ref.generate(q, st_ref)
    assert out_tp == out_ref


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_pool_tp_guards():
    from kvzip_tpu.parallel import make_mesh

    mesh = make_mesh(4, tp=2)
    eng = _engine(mesh, "none")
    st = eng.prefill(CTX, prefill_chunk_size=200)
    eng.prune(st, 0.5, "pair")
    with pytest.raises(ValueError, match="mesh-specific"):
        eng.save_state(st, "/tmp/should_not_exist")
