"""The port's continuous-batching engine (deepgemm_tpu_torch/serving/
engine.py) against the JAX package's: the page allocator step by step, the
same admit/prefill/step/finish script through both engines (flat and
gather-fused decode), a JAX engine's cache carried across into one port
compute step, and the port's own batch
invariance, chunked prefill, page reuse and exhaustion."""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepgemm_tpu.models.indexer import indexer_sparse_decode as jax_sparse_decode
from deepgemm_tpu.serving import ContinuousBatcher as JaxBatcher
from deepgemm_tpu.serving import PageAllocator as JaxAllocator
from deepgemm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from deepgemm_tpu_torch.models.indexer import indexer_sparse_decode
from deepgemm_tpu_torch.serving import ContinuousBatcher, PageAllocator
from deepgemm_tpu_torch.testing import assert_bitwise_equal, calc_diff

H, D, HI, DI = 2, 64, 2, 32
BLOCK_KV = 64


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _e4m3(x):
    return np.clip(np.asarray(x, np.float32), -448, 448).astype(ml_dtypes.float8_e4m3fn)


def token_streams(tokens):
    """Deterministic per-token decode streams as numpy arrays (a server plugs
    the model's projections in here), as tests/test_serving.py:19-34 makes
    them: q, iq, iw, k, v, ik, isf."""
    rngs = [np.random.RandomState(7919 + int(x)) for x in tokens]
    q = _bf16(np.stack([r.randn(H, D) for r in rngs]))
    iq = _bf16(np.stack([r.randn(HI, DI) for r in rngs]))
    iw = np.stack([r.rand(HI) for r in rngs]).astype(np.float32)
    k = _bf16(np.stack([r.randn(H, D) for r in rngs]))
    v = _bf16(np.stack([r.randn(H, D) for r in rngs]))
    ik = _e4m3(np.stack([r.randn(DI) for r in rngs]))
    isf = np.stack([r.rand() + 0.5 for r in rngs]).astype(np.float32)
    return q, iq, iw, k, v, ik, isf


def prompt_streams(seed, t):
    r = np.random.RandomState(seed)
    return (_bf16(r.randn(t, H, D)), _bf16(r.randn(t, H, D)), _e4m3(r.randn(t, DI)),
            (r.rand(t) + 0.5).astype(np.float32))


def _port(arrays):
    return tuple(tensor_from_numpy(a, device='cpu') for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def make_engine(slots=4, num_blocks=24, topk=8):
    return ContinuousBatcher(
        max_slots=slots, max_pages_per_seq=4, num_blocks=num_blocks, block_kv=BLOCK_KV,
        num_heads=H, head_dim=D, index_heads=HI, index_dim=DI, topk=topk,
        embed_fn=lambda tokens: _port(token_streams(tokens.numpy())), device='cpu')


def make_jax_engine(slots=4, num_blocks=24, topk=8):
    return JaxBatcher(
        max_slots=slots, max_pages_per_seq=4, num_blocks=num_blocks, block_kv=BLOCK_KV,
        num_heads=H, head_dim=D, index_heads=HI, index_dim=DI, topk=topk,
        embed_fn=lambda tokens: _jax(token_streams(np.asarray(tokens))))


def test_page_allocator_mirrors_jax():
    """The same pages from both allocators through one script of allocs and
    frees, quad-, pair- and single-sized, and the JAX suite's checks."""
    for n in (4, 8, 9, 11, 24):
        port, ref = PageAllocator(n), JaxAllocator(n)
        held = []
        script = [('alloc', 3), ('quad',), ('pair',), ('alloc', 1), ('free', 0), ('alloc', 2),
                  ('free', 2), ('quad',), ('alloc', 5), ('free', 1), ('free', 3), ('pair',)]
        for op in script:
            if op[0] == 'free':
                if op[1] < len(held) and held[op[1]]:
                    port.free(held[op[1]])
                    ref.free(held[op[1]])
                    held[op[1]] = []
                continue
            try:
                want = getattr(ref, {'alloc': 'alloc', 'quad': 'alloc_quad',
                                     'pair': 'alloc_pair'}[op[0]])(*op[1:])
            except MemoryError:
                with pytest.raises(MemoryError):
                    port.alloc(*op[1:])
                continue
            got = getattr(port, {'alloc': 'alloc', 'quad': 'alloc_quad',
                                 'pair': 'alloc_pair'}[op[0]])(*op[1:])
            assert got == want, (n, op)
            held.append(got or [])
            assert port.num_free == ref.num_free
    a = PageAllocator(4)
    p1, p2 = a.alloc(2), a.alloc(2)
    assert sorted(p1 + p2) == [0, 1, 2, 3] and a.num_free == 0
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.free(p1)
    assert a.alloc(2) == p1
    al = PageAllocator(8)
    q = al.alloc(4)
    assert q == list(range(q[0], q[0] + 4)) and q[0] % 4 == 0
    b = al.alloc(3)
    assert b[1] == b[0] + 1 and b[0] % 2 == 0
    al.free(q)
    al.free(b)
    c = al.alloc(8)
    assert all(c[i:i + 4] == list(range(c[i], c[i] + 4)) and c[i] % 4 == 0 for i in (0, 4))


def _script(engine, prompt=prompt_streams, to=_port):
    """Two sequences, a third admitted mid-flight, the second finished: each
    step's outputs by (label, step)."""
    s1, s2 = engine.admit(70), engine.admit(10)
    engine.prefill(s1, *to(prompt(1, 70)))              # spans 2 pages
    engine.prefill(s2, *to(prompt(2, 10)))
    outs, alive, s3 = {}, {'a': s1, 'b': s2}, None
    for step in range(6):
        if step == 2:
            s3 = engine.admit(5)
            engine.prefill(s3, *to(prompt(3, 5)))
            alive['c'] = s3
        if step == 4:
            engine.finish(alive.pop('b'))
        base = {'a': 100, 'b': 200, 'c': 300}
        tokens = {sid: base[label] + step for label, sid in alive.items()}
        res = engine.step(tokens)
        for label, sid in alive.items():
            out = res[sid]
            outs[label, step] = (out.float().numpy() if isinstance(out, torch.Tensor)
                                 else np.asarray(out, np.float32))
    return outs


def test_engine_matches_jax():
    """One admit/prefill/step/finish script through the JAX engine and the
    port's: the same block tables and context lengths, and each output
    within calc_diff 1e-5."""
    ref, port = make_jax_engine(), make_engine()
    want = _script(ref, to=_jax)
    got = _script(port)
    assert want.keys() == got.keys()
    np.testing.assert_array_equal(port.block_table, ref.block_table)
    np.testing.assert_array_equal(port.context_lens, ref.context_lens)
    for key in want:
        assert calc_diff(got[key], want[key]) < 1e-5, key

    # the JAX engine's state carried across, then one port compute step
    c = ref.cache
    state = params_from_jax({name: np.asarray(getattr(c, name)) for name in
                             ('k_pages', 'v_pages', 'ik_pages', 'isf_pages')}, device='cpu')
    streams = token_streams(np.arange(4) + 400)
    q, iq, iw = streams[:3]
    args = (np.asarray(ref.context_lens), np.asarray(ref.block_table), ref.max_context_len,
            ref.topk)
    jax_out = jax_sparse_decode(jnp.asarray(q)[:, None], (c.k_pages, c.v_pages),
                                (c.ik_pages, c.isf_pages), jnp.asarray(iq)[:, None],
                                jnp.asarray(iw), *map(jnp.asarray, args[:2]), *args[2:])
    port_out = indexer_sparse_decode(
        tensor_from_numpy(q, 'cpu')[:, None], (state['k_pages'], state['v_pages']),
        (state['ik_pages'], state['isf_pages']), tensor_from_numpy(iq, 'cpu')[:, None],
        torch.from_numpy(iw), torch.from_numpy(args[0]), torch.from_numpy(args[1]), *args[2:])
    live = np.asarray(ref.context_lens) > 0
    assert calc_diff(port_out[live], np.asarray(jax_out, np.float32)[live]) < 1e-5


def test_engine_under_pallas_matches_jax(monkeypatch):
    """The same script with DGT_SPARSE_GATHER=pallas in both engines: the
    port's gather-fused decode (its plain version here) within 1e-5 of the
    JAX engine (which, at this head_dim of 64, takes its flat gather: the
    same function), and bitwise equal to the port's own 'flat' run."""
    flat = _script(make_engine())
    monkeypatch.setenv('DGT_SPARSE_GATHER', 'pallas')
    want = _script(make_jax_engine(), to=_jax)
    got = _script(make_engine())
    assert want.keys() == got.keys() == flat.keys()
    for key in want:
        assert calc_diff(got[key], want[key]) < 1e-5, key
        assert_bitwise_equal(got[key], flat[key], f'pallas vs flat {key}')


def test_batch_invariance_bitwise():
    """A sequence's outputs do not depend on which others share the batch:
    each of two sequences alone in a fresh engine gives the same bits."""
    outs = _script(make_engine())
    for label, seed, t0, tok0, steps in (('a', 1, 70, 100, range(6)), ('c', 3, 5, 300,
                                                                        range(2, 6))):
        eng = make_engine()
        sid = eng.admit(t0)
        eng.prefill(sid, *_port(prompt_streams(seed, t0)))
        for step in steps:
            assert_bitwise_equal(eng.step({sid: tok0 + step})[sid].float(), outs[label, step],
                                 f'{label} step {step}')


def test_chunked_prefill_across_pages_matches_one_call():
    """A prompt written in chunks that start and end inside pages gives the
    same cache rows and the same decode outputs, bit for bit, as one call;
    each chunk writes exactly its rows."""
    k, v, ik, isf = _port(prompt_streams(9, 150))
    one, chunked = make_engine(), make_engine()
    s_one, s_chunk = one.admit(150), chunked.admit(40)
    one.prefill(s_one, k, v, ik, isf)
    for a, b in ((0, 40), (40, 100), (100, 150)):
        chunked.prefill(s_chunk, k[a:b], v[a:b], ik[a:b], isf[a:b])
    for eng, sid in ((one, s_one), (chunked, s_chunk)):
        pages = eng._seq(sid).pages
        rows = eng.cache.k_pages[pages].reshape(-1, H, D)
        assert_bitwise_equal(rows[:150], k, 'prefilled k rows')
        assert not rows[150:].float().any()                       # nothing past the prompt
        assert_bitwise_equal(eng.cache.ik_pages[pages].reshape(-1, DI)[:150], ik, 'ik rows')
    for step in range(3):
        assert_bitwise_equal(chunked.step({s_chunk: 7 + step})[s_chunk],
                             one.step({s_one: 7 + step})[s_one], f'step {step}')


def test_page_reuse_slot_recycling_and_exhaustion():
    eng = make_engine(slots=2, num_blocks=5)
    s1 = eng.admit(BLOCK_KV)
    s2 = eng.admit(BLOCK_KV * 2)
    assert eng.alloc.num_free == 2
    assert eng.admit(BLOCK_KV * 3) is None                  # no slot free
    eng.prefill(s1, *_port(prompt_streams(4, BLOCK_KV)))
    eng.finish(s1)
    assert eng.alloc.num_free == 3
    s4 = eng.admit(BLOCK_KV * 2)                            # recycles the slot and pages
    eng.prefill(s4, *_port(prompt_streams(5, BLOCK_KV * 2)))
    out = eng.step({s4: 42})                                # appends past the page boundary
    assert torch.isfinite(out[s4].float()).all()
    eng.finish(s4)
    eng.finish(s2)
    assert eng.alloc.num_free == 5
    full = make_engine(slots=2, num_blocks=2)
    s = full.admit(BLOCK_KV * 2)
    full.prefill(s, *_port(prompt_streams(6, BLOCK_KV * 2)))
    with pytest.raises(MemoryError):
        full.step({s: 1})                                   # a tail page is needed, none free


def test_decode_growth_keeps_quads():
    eng = make_engine(slots=1, num_blocks=8)
    s = eng.admit(BLOCK_KV)
    eng.prefill(s, *_port(prompt_streams(BLOCK_KV, BLOCK_KV)))
    for i in range(3 * BLOCK_KV):                           # grow to 4 pages, a page at a time
        eng.step({s: i})
    pages = eng._seq(s).pages
    assert pages == list(range(pages[0], pages[0] + 4)) and pages[0] % 4 == 0
    eng.finish(s)
    assert eng.alloc.num_free == 8
