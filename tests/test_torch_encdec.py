"""The port's encoder-decoder family (whisper-base: a bidirectional encoder
over precomputed frame embeddings, a causal decoder with cross-attention)
against the JAX reference.

Params come from the reference's ``api.init`` and are carried across by
``convert``; frames are N(0, 0.1^2) from a seed, as the reference's
tests/test_models.py draws them.  The reference's functions are jitted, as
tests/test_torch_moe.py does.  On the CPU the encoder's self-attention and
the prefill's cross-attention take the flash kernel's plain version
without causality (``flash_attention(..., causal=False)``), where the
reference computes plain attention with an all-true mask; decode steps are
plain in both.

Tolerances: 2e-5 absolute (rtol 1e-5) on the encoder's states, hidden
states, logits and every cache leaf, as tests/test_torch_transformer.py
(2.6e-6 observed); the reference's 2e-4 for decode against the full
forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as R
from repro.models import api as japi
from repro.models import encdec as JE
from repro_torch import convert
from repro_torch.configs import whisper_base
from repro_torch.kernels import LAUNCHES
from repro_torch.models import api as tapi
from repro_torch.models import encdec as TE
from repro_torch.serving import ServeEngine, reference_decode

ATOL, RTOL = 2e-5, 1e-5
STEPWISE_TOL = 2e-4

_jencode = jax.jit(JE.encode, static_argnums=0)
_jstack = jax.jit(JE.decode_stack, static_argnums=(0, 4),
                  static_argnames="cache_seq")
_jprefill = jax.jit(JE.prefill, static_argnums=0,
                    static_argnames="target_seq")
_jdecode = jax.jit(JE.decode_step, static_argnums=0)


@pytest.fixture(scope="module")
def model():
    jcfg = R.get_smoke_config("whisper-base")
    tcfg = whisper_base.smoke_config()
    jp = jax.jit(japi.init, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(np_params, device="cpu")
    return jcfg, tcfg, jp, tp, np_params


def _frames(cfg, seed=0, B=2):
    return (0.1 * np.random.RandomState(seed).randn(
        B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(S, seed=1, B=2):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _close_caches(got, want):
    assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape)
        _close(got[key].numpy(), want[key])


def test_port_init_matches_reference_layout(model):
    _, tcfg, _, _, np_params = model
    mine = convert.lm_params_to_numpy(tapi.init(tcfg, seed=0, device="cpu"))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(np_params)
    assert [(p, a.shape, a.dtype) for p, a in flat_m] == \
        [(p, a.shape, a.dtype) for p, a in flat_r]
    assert not mine["enc_norm"].any() and not mine["layers"]["ln_x"].any()
    d = tcfg.d_model
    assert abs(mine["layers"]["cross"]["wk"].std() * np.sqrt(d) - 1) < 0.05
    assert abs(mine["embed"].std() / 0.02 - 1.0) < 0.05


def test_convert_round_trip_is_bitwise(model):
    jcfg, _, jp, _, np_params = model
    _, jcache = _jprefill(jcfg, jp, jnp.asarray(_tokens(9)),
                          jnp.asarray(_frames(jcfg)), target_seq=16)
    for tree in (np_params, jax.tree_util.tree_map(np.asarray, jcache)):
        back = convert.lm_params_to_numpy(
            convert.lm_params_from_numpy(tree, device="cpu"))
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


def test_encode_matches(model):
    jcfg, tcfg, jp, tp, _ = model
    frames = _frames(jcfg, seed=3)
    before = dict(LAUNCHES)
    got = TE.encode(tcfg, tp, torch.from_numpy(frames))
    assert LAUNCHES == before                 # CPU: the plain version
    assert got.shape == frames.shape
    _close(got.numpy(), _jencode(jcfg, jp, jnp.asarray(frames)))


@pytest.mark.parametrize("S,cache_seq", [(1, None), (12, None), (12, 20)])
def test_decode_stack_matches(model, S, cache_seq):
    """The decoder's hidden states and, with a cache, its self k/v (the
    first S of ``cache_seq`` slots) and cross k/v."""
    jcfg, tcfg, jp, tp, _ = model
    enc = np.array(_jencode(jcfg, jp, jnp.asarray(_frames(jcfg))))
    toks = _tokens(S, seed=S)
    jh, jc = _jstack(jcfg, jp, jnp.asarray(toks), jnp.asarray(enc), True,
                     cache_seq=cache_seq)
    th, tc = TE.decode_stack(tcfg, tp, torch.from_numpy(toks),
                             torch.from_numpy(enc), True, cache_seq)
    _close(th.numpy(), jh)
    _close_caches(tc, jc)
    th, none = TE.decode_stack(tcfg, tp, torch.from_numpy(toks),
                               torch.from_numpy(enc))
    assert none is None
    _close(th.numpy(), jh)


@pytest.mark.parametrize("S", [1, 5, 20])
def test_prefill_and_decode_steps_match(model, S):
    """``api.prefill`` with frames (logits, k, v, xk, xv), then three
    decode steps at scalar positions."""
    jcfg, tcfg, jp, tp, _ = model
    toks, frames = _tokens(S, seed=S), _frames(jcfg, seed=S)
    jl, jc = _jprefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(frames),
                       target_seq=S + 4)
    tl, tc = tapi.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                     "frames": torch.from_numpy(frames)},
                          target_seq=S + 4)
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_size)
    _close(tl.numpy(), jl)
    _close_caches(tc, jc)
    tok = np.array([[3], [7]], np.int32)
    for step in range(3):
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(S + step))
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(tok), S + step)
        _close(tl.numpy(), jl)
        _close_caches(tc, jc)
        tok = (tok * 5 + step) % tcfg.vocab_size


def test_decode_with_per_row_positions(model):
    """A (B,) vector of positions, each row at its own depth.  The
    reference's encdec ``decode_step`` reads a (B,) vector as a sequence
    of B positions and fails for B > 1 (ROADMAP queue 3): each row is held
    against the reference decoding that row alone."""
    jcfg, tcfg, jp, tp, _ = model
    lens, target = (4, 9), 13
    frames = _frames(jcfg, seed=5)
    prompts = [_tokens(L, seed=L, B=1) for L in lens]
    caches = [tapi.prefill(tcfg, tp, {
        "tokens": torch.from_numpy(t),
        "frames": torch.from_numpy(frames[r:r + 1])}, target_seq=target)[1]
        for r, t in enumerate(prompts)]
    tc = {k: torch.cat([c[k] for c in caches], dim=1) for k in caches[0]}
    jcs = [_jprefill(jcfg, jp, jnp.asarray(t), jnp.asarray(frames[r:r + 1]),
                     target_seq=target)[1] for r, t in enumerate(prompts)]
    tok = np.array([[3], [7]], np.int32)
    pos = np.array(lens, np.int64)
    for step in range(3):
        tl, tc = tapi.decode(tcfg, tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(pos + step))
        for r in range(2):
            jl, jcs[r] = _jdecode(jcfg, jp, jcs[r], jnp.asarray(tok[r:r + 1]),
                                  jnp.int32(pos[r] + step))
            _close(tl[r:r + 1].numpy(), jl)
        tok = (tok * 5 + step) % tcfg.vocab_size


def test_decode_matches_full_forward(model):
    """Prefill, then decode fed the next tokens: each step's logits equal
    a prefill over the whole sequence so far within 2e-4 (the reference's
    bound), and the batch's rows equal each row decoded alone."""
    _, tcfg, _, tp, _ = model
    S, gen = 6, 8
    seq = torch.from_numpy(_tokens(S + gen, seed=7))
    frames = torch.from_numpy(_frames(tcfg, seed=7))
    logits, cache = TE.prefill(tcfg, tp, seq[:, :S], frames,
                               target_seq=S + gen)
    rows = [TE.prefill(tcfg, tp, seq[r:r + 1, :S], frames[r:r + 1],
                       target_seq=S + gen) for r in range(2)]
    for i in range(S, S + gen):
        logits, cache = TE.decode_step(tcfg, tp, cache, seq[:, i:i + 1], i)
        full, _ = TE.prefill(tcfg, tp, seq[:, :i + 1], frames)
        assert float((logits - full).abs().max()) < STEPWISE_TOL
        for r in range(2):
            alone, c = TE.decode_step(tcfg, tp, rows[r][1],
                                      seq[r:r + 1, i:i + 1], i)
            rows[r] = (alone, c)
            assert float((alone - logits[r:r + 1]).abs().max()) < \
                STEPWISE_TOL


def test_prefill_needs_frames(model):
    """``api.prefill`` passes ``batch["frames"]`` (not ``patches``) and
    raises without them, as the VLM does without patches; the sequential
    oracle takes no frames, so it raises too."""
    _, tcfg, _, tp, _ = model
    toks = torch.from_numpy(_tokens(5))
    with pytest.raises(ValueError, match="frames"):
        tapi.prefill(tcfg, tp, {"tokens": toks})
    with pytest.raises(ValueError, match="frames"):
        tapi.prefill(tcfg, tp, {"tokens": toks, "patches": torch.zeros(
            (2, tcfg.encoder_seq, tcfg.d_model))})
    with pytest.raises(ValueError, match="frames"):
        reference_decode(tcfg, tp, _tokens(5, B=1)[0], 2)
    logits, _ = tapi.prefill(tcfg, tp, {
        "tokens": toks, "frames": torch.from_numpy(_frames(tcfg))})
    assert torch.isfinite(logits).all()


def test_family_dispatch_and_refusals(model):
    """``api`` dispatches whisper to ``encdec``, whose training loss
    (``tests/test_torch_lm_loss.py`` holds it against the reference) is
    ``api.loss``; the engine refuses the family, as the reference's."""
    _, tcfg, _, tp, _ = model
    assert tapi.get_model(tcfg) is TE
    toks = torch.from_numpy(_tokens(8))
    batch = {"tokens": toks, "labels": toks,
             "frames": torch.from_numpy(_frames(tcfg))}
    with torch.no_grad():
        assert torch.equal(tapi.loss(tcfg, tp, batch),
                           TE.loss_fn(tcfg, tp, batch))
    with pytest.raises(NotImplementedError, match="families"):
        ServeEngine(tcfg, tp)


def test_init_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: init(device=None) would use it")
    cfg = whisper_base.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_cache(cfg, 1, 8, torch.float32)


def test_full_width_param_count():
    """whisper-base's params, counted from the reference init's shapes:
    97,166,336, ``param_count()`` plus its 32 norm vectors."""
    cfg = whisper_base.CONFIG
    shapes = jax.eval_shape(
        lambda k: JE.init(R.get_config("whisper-base"), k, jnp.float32),
        jax.random.PRNGKey(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    norms = (2 * cfg.encoder_layers + 3 * cfg.num_layers + 2) * cfg.d_model
    assert n == cfg.param_count() + norms == 97_166_336
