"""The port's RAG pipeline (``repro_torch.serving.RagPipeline``) against
the reference's (``repro.serving.RagPipeline``): the reduced tinyllama on
the reference's weights (carried by ``params_from_reference``, fp32 on both
sides) over the reference's built index (carried by
``PilotANNIndex.from_arrays``).  embed within 1e-5; retrieve gives the
same ids; generate the same tokens wherever the reference's top-2 logit
margin is above 1e-3 (the bf16 KV cache can turn a closer tie), and at
least 0.95 of them overall."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.models import init_params as j_init_params
from repro.serving import RagPipeline as JRag
from repro_torch import configs as TC
from repro_torch.core import IndexConfig, PilotANNIndex
from repro_torch.models import init_params as t_init_params
from repro_torch.models import params_from_reference
from repro_torch.serving import RagPipeline as TRag

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
B, S = 4, 16


def _context_for(vocab):
    def context_tokens_for(i: int) -> np.ndarray:
        return np.random.default_rng(i).integers(0, vocab, S).astype(np.int32)
    return context_tokens_for


@pytest.fixture(scope="module")
def pipelines(built_index):
    jcfg = JC.reduced(JC.get_config(ARCH))
    tcfg = TC.reduced(TC.get_config(ARCH))
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               "cpu").float()
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    index = PilotANNIndex.from_arrays(
        IndexConfig(**CFG),
        {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")
    tok = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return (JRag(index=built_index, params=jp32, cfg=jcfg),
            TRag(index=index, params=tp, cfg=tcfg), tok)


@pytest.fixture(scope="module")
def generated(pipelines):
    """One generate of each pipeline (about 10 s in the reference), and the
    reference's greedy logits margins recomputed from its own tokens."""
    jrag, trag, tok = pipelines
    ctx = _context_for(jrag.cfg.vocab_size)
    return jrag.generate(tok, ctx), trag.generate(tok, ctx)


def test_defaults_are_the_reference_s(pipelines):
    jrag, trag, _ = pipelines
    assert trag.max_new_tokens == jrag.max_new_tokens == 8
    for f in ("k", "ef", "ef_pilot"):
        assert getattr(trag.search_params, f) == getattr(jrag.search_params, f)


def test_embed_matches_reference(pipelines):
    jrag, trag, tok = pipelines
    want = jrag.embed(tok)
    got = trag.embed(tok)
    assert got.shape == want.shape == (B, trag.cfg.d_model)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    for short in (tok[:, :3], tok[:1]):            # truncated and tiled dims
        np.testing.assert_allclose(trag.embed_to_corpus_dim(short),
                                   jrag.embed_to_corpus_dim(short),
                                   rtol=1e-5, atol=1e-5)


def test_embed_to_corpus_dim_tiles_a_narrow_embedding(pipelines):
    _, trag, tok = pipelines
    trag.index.d, d = 150, trag.index.d
    try:
        got = trag.embed_to_corpus_dim(tok)
    finally:
        trag.index.d = d
    emb = trag.embed(tok)
    assert got.shape == (B, 150)
    np.testing.assert_array_equal(got[:, :64], emb)
    np.testing.assert_array_equal(got[:, 128:], emb[:, :22])


def test_retrieve_matches_reference(pipelines):
    jrag, trag, tok = pipelines
    jids, jd = jrag.retrieve(tok)
    tids, td = trag.retrieve(tok)
    assert tids.shape == (B, 4)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)


def test_generate_matches_reference(pipelines, generated):
    jrag, trag, tok = pipelines
    (jout, jids), (tout, tids) = generated
    np.testing.assert_array_equal(tids, jids)
    assert tout.shape == jout.shape == (B, 8) and tout.dtype == np.int32
    assert ((tout >= 0) & (tout < trag.cfg.vocab_size)).all()
    same = tout == jout
    assert same.mean() >= 0.95
    # where a token differs, it was a near-tie of the reference's logits at
    # that step (decode the reference's own tokens to read its margins)
    if not same.all():
        margins = _reference_margins(jrag, tok, jids, jout)
        assert (margins[~same] <= 1e-3).all(), margins[~same]


def _reference_margins(jrag, tok, jids, jout):
    from repro.models import decode_step, init_caches
    ctx = np.stack([np.concatenate([_context_for(jrag.cfg.vocab_size)(
        int(jids[b, 0])), tok[b]])[-S:] for b in range(B)])
    seq = np.concatenate([ctx, jout], axis=1)
    caches = init_caches(jrag.params, jrag.cfg, B, seq.shape[1])
    out = []
    for t in range(seq.shape[1] - 1):
        lg, caches = decode_step(jrag.params, jrag.cfg,
                                 jnp.asarray(seq[:, t:t + 1]), caches,
                                 jnp.int32(t))
        if t >= S - 1:
            top2 = np.sort(np.asarray(lg)[:, 0], -1)[:, -2:]
            out.append(top2[:, 1] - top2[:, 0])
    return np.stack(out, 1)


def test_pipeline_refuses_two_devices(pipelines):
    _, trag, _ = pipelines

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="one device"):
        TRag(index=trag.index, params=Elsewhere(), cfg=trag.cfg)


def test_generate_with_the_port_s_own_weights(pipelines):
    """The port's own init (bf16, from a torch.Generator) through the
    whole pipeline: tokens in the vocabulary, retrieval ids in the corpus,
    the same answer twice."""
    _, trag, tok = pipelines
    rag = TRag(index=trag.index, params=t_init_params(trag.cfg, seed=1,
                                                      device="cpu"),
               cfg=trag.cfg, max_new_tokens=3)
    out, ids = rag.generate(tok[:2], _context_for(trag.cfg.vocab_size))
    again, ids2 = rag.generate(tok[:2], _context_for(trag.cfg.vocab_size))
    assert out.shape == (2, 3)
    assert ((out >= 0) & (out < trag.cfg.vocab_size)).all()
    assert ((ids >= 0) & (ids < trag.index.n)).all()
    np.testing.assert_array_equal(out, again)
    np.testing.assert_array_equal(ids, ids2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-7b", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_generate_with_every_generator_family(pipelines, arch):
    """Each family's reduced model (its own init) as the generator over the
    same index: the retrieval is ``index.search`` of its embedding, tokens
    in the vocabulary, the same answer twice."""
    _, trag, tok = pipelines
    cfg = TC.reduced(TC.get_config(arch))
    rag = TRag(index=trag.index, params=t_init_params(cfg, seed=2,
                                                      device="cpu"),
               cfg=cfg, max_new_tokens=3)
    q = tok[:2] % cfg.vocab_size
    out, ids = rag.generate(q, _context_for(cfg.vocab_size))
    again, _ = rag.generate(q, _context_for(cfg.vocab_size))
    want, _, _ = trag.index.search(rag.embed_to_corpus_dim(q),
                                   rag.search_params)
    np.testing.assert_array_equal(ids, want)
    assert out.shape == (2, 3)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    np.testing.assert_array_equal(out, again)


def test_whisper_is_no_generator(pipelines):
    """The encoder-decoder needs frames the pipeline cannot feed (as in the
    reference): embedding a query raises, naming them."""
    _, trag, tok = pipelines
    cfg = TC.reduced(TC.get_config("whisper-medium"))
    rag = TRag(index=trag.index, params=t_init_params(cfg, device="cpu"),
               cfg=cfg)
    with pytest.raises(ValueError, match="frontend_embeds"):
        rag.retrieve(tok[:2])
