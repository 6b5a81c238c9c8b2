"""The port's training path (``seal_tpu_torch.training``, ``cli.train``) on
the CPU against the JAX package's on the same seeded numpy inputs.

Tolerances: the loss and its gradient within 1e-5 relative / 1e-7
absolute (f32 log-softmax over 97 columns, sums in another order); the
optimizer's p, mu and nu within 1e-6 relative (the same f32 operations in
the same order; the bias corrections and the global norm may round one ulp
apart); three tiny-BART train steps: the losses within 1e-5 relative and
the parameters within 1e-6 absolute (f32 GEMMs in another summation order,
then three Adam steps of lr <= 1e-3); the count exactly.  Checkpoints and
``make_batches`` exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seal_tpu.cli import train as jcli
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.models.tokenizer import WordVocabTokenizer
from seal_tpu.training import checkpoint as jckpt
from seal_tpu.training import trainer as jt
from seal_tpu_torch.cli import train as tcli
from seal_tpu_torch.kernels import adamw, train_loss
from seal_tpu_torch.models import convert
from seal_tpu_torch.models.config import bart_tiny
from seal_tpu_torch.training import checkpoint as tckpt
from seal_tpu_torch.training import trainer as tt

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
OPT_RTOL, OPT_ATOL = 1e-6, 1e-9
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-6


def _logits(eps_seed=0):
    rng = np.random.default_rng(eps_seed)
    x = (rng.normal(size=(3, 7, 97)) * 3).astype(np.float32)
    t = rng.integers(0, 97, size=(3, 7)).astype(np.int32)
    t[0, 3:] = 1  # pad
    t[2, :] = 1
    return x, t


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_loss_and_gradient_match_jax(eps):
    x, t = _logits()
    jl, jn = jt.label_smoothed_nll(jnp.asarray(x), jnp.asarray(t), 1, eps)
    jg = jax.grad(lambda z: jt.label_smoothed_nll(z, jnp.asarray(t), 1, eps)[0])(jnp.asarray(x))
    # the plain version: the loss and its autograd gradient
    xt = torch.tensor(x, requires_grad=True)
    pl, pn = train_loss.label_smoothed_nll_plain(xt, torch.tensor(t), 1, eps)
    (pg,) = torch.autograd.grad(pl, xt)
    # the entry point (the autograd function: the closed-form backward)
    xt2 = torch.tensor(x, requires_grad=True)
    l, n = tt.label_smoothed_nll(xt2, torch.tensor(t), 1, eps)
    (g,) = torch.autograd.grad(l, xt2)
    assert float(jn) == pn.item() == n.item() == 10.0
    for loss in (pl, l):
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for grad in (pg, g):
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    # the closed form against autograd, given the forward's lse and ntok
    x2, t2 = torch.tensor(x).reshape(-1, 97), torch.tensor(t).reshape(-1)
    _, ntok, lse = train_loss.nll_forward(x2, t2, 1, eps)
    closed = train_loss.nll_backward_plain(x2, t2, lse, ntok, torch.tensor(1.0), 1, eps)
    np.testing.assert_allclose(closed.numpy(), pg.reshape(-1, 97).numpy(), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_all_pad_batch_gives_zero():
    x, _ = _logits()
    t = np.ones((3, 7), np.int32)
    xt = torch.tensor(x, requires_grad=True)
    loss, ntok = tt.label_smoothed_nll(xt, torch.tensor(t), 1, 0.1)
    (g,) = torch.autograd.grad(loss, xt)
    jl, jn = jt.label_smoothed_nll(jnp.asarray(x), jnp.asarray(t), 1, 0.1)
    assert loss.item() == float(jl) == 0.0 and ntok.item() == float(jn) == 1.0
    assert not g.any()


def _tree(rng, scale=1.0):
    return {"b": (rng.normal(size=(7,)) * scale).astype(np.float32),
            "a": (rng.normal(size=(3, 5)) * scale).astype(np.float32),
            "layers": [{"w": (rng.normal(size=(4, 4)) * scale).astype(np.float32)}]}


def _to_torch(tree):
    return convert.params_from_jax(tree, None, device="cpu")


def _assert_tree_close(torch_tree, jax_tree, rtol, atol):
    for a, b in zip(tt.tree_leaves(torch_tree), jax.tree_util.tree_leaves(jax_tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("start", ["init", "jax_state"])
def test_optimizer_matches_optax(start):
    """4 steps at warm-up 2, total 6: lr 0 at count 0, the ramp, the decay;
    the gradients' norm above max_norm (0.1) at steps 0 and 2, below at 1
    and 3.  ``jax_state``: both start from a JAX state with non-zero
    moments and counts, through ``opt_state_from_jax``."""
    rng = np.random.default_rng(1)
    tcfg = jt.TrainConfig(warmup_steps=2, total_steps=6, learning_rate=1e-2)
    opt = jt.make_optimizer(tcfg)
    params = _tree(rng)
    jstate = opt.init(params)
    if start == "jax_state":
        adam = jstate[1][0]._replace(count=jnp.asarray(3, jnp.int32), mu=_tree(rng, 0.01),
                                     nu=jax.tree_util.tree_map(np.abs, _tree(rng, 1e-4)))
        jstate = (jstate[0], (adam, jstate[1][1], jstate[1][2]._replace(
            count=jnp.asarray(3, jnp.int32))))

    @jax.jit
    def jstep(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    tparams = _to_torch(params)
    topt = tt.make_optimizer(tt.TrainConfig(**tcfg.__dict__))
    tstate = (convert.opt_state_from_jax(jax.device_get(jstate), "cpu") if start == "jax_state"
              else topt.init(tparams))
    p = params
    for scale in (1.0, 0.005, 0.5, 0.01):
        grads = _tree(rng, scale)
        p, jstate = jstep(p, jstate, grads)
        tstate = topt.update(_to_torch(grads), tstate, tparams)
        adam, _, sched = jax.device_get(jstate)[1]
        assert (tstate.count, tstate.schedule_count) == (int(adam.count), int(sched.count))
        _assert_tree_close(tparams, p, OPT_RTOL, OPT_ATOL)
        _assert_tree_close(tstate.mu, adam.mu, OPT_RTOL, OPT_ATOL)
        _assert_tree_close(tstate.nu, adam.nu, OPT_RTOL, 1e-15)


def test_global_norm_and_schedule_match_optax():
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    np.testing.assert_allclose(adamw.global_norm(tt.tree_leaves(_to_torch(grads))).item(),
                               float(optax.global_norm(grads)), rtol=1e-6)
    for warmup, total in ((3, 10), (0, 5), (4, 4)):
        tcfg = jt.TrainConfig(warmup_steps=warmup, total_steps=total, learning_rate=3e-4)
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, 3e-4, warmup),
             optax.polynomial_schedule(3e-4, 0.0, 1.0, max(total - warmup, 1))], [warmup])
        for c in range(total + 2):
            assert float(tt.learning_rate(tcfg, c)) == float(sched(c)), (warmup, total, c)


def _batches(rng, n, vocab=61, B=4, S=12, T=9):
    out = []
    for _ in range(n):
        src = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
        sm = np.ones((B, S), np.int32)
        src[1, 8:], sm[1, 8:] = 1, 0
        tgt_out = rng.integers(3, vocab, size=(B, T)).astype(np.int32)
        tgt_out[2, 5:] = 1
        out.append(dict(src_ids=src, src_mask=sm,
                        tgt_in=rng.integers(3, vocab, size=(B, T)).astype(np.int32),
                        tgt_out=tgt_out))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """3 JAX train steps of bart_tiny (f32) from seeded params: the start
    params, the batches, the losses and the final state."""
    jcfg = jtiny(vocab_size=61)
    tcfg = jt.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    params, state = jt.init_train_state(jcfg, tcfg, jax.random.PRNGKey(0))
    start = jax.device_get(params)
    step, _ = jt.make_train_step(jcfg, tcfg)
    step = jax.jit(step)
    batches = _batches(np.random.default_rng(3), 3)
    losses = []
    for b in batches:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return dict(tcfg=tcfg, start=start, batches=batches, losses=losses,
                params=jax.device_get(params), state=jax.device_get(state))


def test_train_steps_match_jax(jax_steps):
    cfg = bart_tiny(vocab_size=61)
    tcfg = tt.TrainConfig(**jax_steps["tcfg"].__dict__)
    params = convert.params_from_jax(jax_steps["start"], cfg, device="cpu")
    step, opt = tt.make_train_step(cfg, tcfg)
    state = opt.init(params)
    for b, want in zip(jax_steps["batches"], jax_steps["losses"]):
        params, state, loss = step(params, state, b)
        assert loss.dim() == 0 and not loss.requires_grad
        np.testing.assert_allclose(loss.item(), want, rtol=STEP_LOSS_RTOL)
    _assert_tree_close(params, jax_steps["params"], 0, STEP_PARAM_ATOL)
    adam = jax_steps["state"][1][0]
    assert state.count == int(adam.count) == 3
    assert not any(p.requires_grad for p in tt.tree_leaves(params))


def test_card_against_cpu_helper_runs_on_cpu():
    """``parity.card_against_cpu``, which the card's checks call, with the
    CPU on both sides: the same losses and params to the bit, no kernel
    launched, and its batches padded where it says."""
    from seal_tpu_torch.training import parity

    res = parity.card_against_cpu("cpu")
    assert res["ok"] and res["loss_err"] == 0.0 and res["param_err"] == 0.0
    assert res["losses"] == res["cpu_losses"] and all(np.isfinite(res["losses"]))
    assert res["launches"] == res["cpu_launches"] == (0, 0)
    b = parity.tiny_batches()[0]
    assert (b["src_mask"][1, 8:] == 0).all() and (b["tgt_out"][2, 5:] == 1).all()


def test_bench_train_batch_at_the_cli_defaults():
    """``bench_train.train_batch`` (the card's train phase feeds it to the
    step): 32 pairs, sources of 128 with their mask, targets of 80 whose
    decoder inputs are the targets shifted right behind the start token."""
    from seal_tpu_torch.bench_train import train_batch

    cfg = bart_tiny(vocab_size=61)
    b = train_batch(cfg)
    assert b["src_ids"].shape == b["src_mask"].shape == (32, 128)
    assert b["tgt_in"].shape == b["tgt_out"].shape == (32, 80)
    assert ((b["src_ids"] == cfg.pad_token_id) == (b["src_mask"] == 0)).all()
    assert (b["tgt_in"][:, 0] == cfg.decoder_start_token_id).all()
    assert (b["tgt_in"][:, 1:] == b["tgt_out"][:, :-1]).all()
    assert 0 < (b["tgt_out"] == cfg.pad_token_id).sum() < b["tgt_out"].size
    assert all((train_batch(cfg)[k] == v).all() for k, v in b.items())


def test_remat_gives_the_same_gradients():
    import dataclasses

    cfg = bart_tiny(vocab_size=61)
    params = convert.params_from_jax(jax.device_get(
        jt.init_train_state(jtiny(vocab_size=61), jt.TrainConfig(), jax.random.PRNGKey(1))[0]),
        cfg, device="cpu")
    batch = tt.batch_to(_batches(np.random.default_rng(4), 1)[0], "cpu")
    leaves = tt.tree_leaves(params)
    grads = []
    for remat in (False, True):
        for p in leaves:
            p.requires_grad_(True)
        loss = tt.loss_fn(dataclasses.replace(cfg, remat=remat), params, batch)
        grads.append((loss.item(), torch.autograd.grad(loss, leaves)))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


def test_checkpoints_round_trip_prune_and_load_in_jax(tmp_path, jax_steps):
    cfg = bart_tiny(vocab_size=61)
    params = convert.params_from_jax(jax_steps["params"], cfg, device="cpu")
    state = convert.opt_state_from_jax(jax_steps["state"], "cpu")
    path = str(tmp_path / "ckpt")
    for s in (10, 20, 30, 40):
        tckpt.save_checkpoint(path, s, params, state, keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "latest.json", "step_30.npz", "step_40.npz"]
    assert tckpt.latest_step(path) == 40 and jckpt.latest_step(path) == 40
    step, got = tckpt.restore_checkpoint(path, {"params": params, "opt_state": state})
    assert step == 40 and (got["opt_state"].count, got["opt_state"].schedule_count) == (3, 3)
    for a, b in zip(tt.tree_leaves([got["params"], got["opt_state"].mu, got["opt_state"].nu]),
                    tt.tree_leaves([params, state.mu, state.nu])):
        assert torch.equal(a, b)
    # the JAX package's npz route restores the port's checkpoint
    jstep, jstate = jckpt.restore_checkpoint(
        path, {"params": jax_steps["params"], "opt_state": jax_steps["state"]})
    assert jstep == 40
    for a, b in zip(jax.tree_util.tree_leaves(jstate["params"]),
                    jax.tree_util.tree_leaves(jax_steps["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(jstate["opt_state"][1][0].count) == 3


def _word_data(tmp_path, texts, reps):
    tok = WordVocabTokenizer.train([" " + t for t in texts])
    tok_path = str(tmp_path / "word_vocab.json")
    tok.save(tok_path)
    (tmp_path / "train.source").write_text("".join(f" {t} || body\n" for t in texts * reps))
    (tmp_path / "train.target").write_text("".join(f" {t}\n" for t in texts * reps))
    return tok, tok_path


def test_make_batches_match_jax(tmp_path):
    tok, _ = _word_data(tmp_path, ["alpha beta gamma", "delta epsilon zeta", "eta theta iota",
                                   "kappa lambda"], 5)
    srcs, tgts = tcli.tokenize_pairs(tok, str(tmp_path / "train.source"),
                                     str(tmp_path / "train.target"), 128, 64)
    assert (srcs, tgts) == jcli.tokenize_pairs(tok, str(tmp_path / "train.source"),
                                               str(tmp_path / "train.target"), 128, 64)
    cfg = jtiny(vocab_size=tok.vocab_size)
    got = list(tcli.make_batches(srcs, tgts, cfg, 3, np.random.default_rng(7)))
    want = list(jcli.make_batches(srcs, tgts, cfg, 3, np.random.default_rng(7)))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)


def test_train_cli_runs_and_resumes_on_cpu(tmp_path, capsys):
    _, tok_path = _word_data(tmp_path, ["alpha beta gamma", "delta epsilon zeta"], 4)
    save = str(tmp_path / "save")
    common = [str(tmp_path / "train"), save, "--tokenizer", tok_path, "--backbone", "tiny",
              "--batch_size", "4", "--save_interval", "100", "--log_interval", "2",
              "--lr", "1e-3", "--device", "cpu"]
    assert tcli.main(common + ["--max_update", "3"]) == 0
    assert tckpt.latest_step(save) == 3
    assert tcli.main(common + ["--max_update", "6", "--resume"]) == 0
    assert tckpt.latest_step(save) == 6
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done at step 6" in out
    logs = [json.loads(line) for line in out.splitlines() if line.startswith('{"step"')]
    assert [r["step"] for r in logs] == [2, 4, 6] and all(np.isfinite(r["loss"]) for r in logs)


def test_unported_routes_and_the_card_default_raise(tmp_path, monkeypatch):
    _, tok_path = _word_data(tmp_path, ["alpha beta"], 2)
    base = [str(tmp_path / "train"), str(tmp_path / "save"), "--tokenizer", tok_path,
            "--backbone", "tiny", "--device", "cpu"]
    # --init_checkpoint loads now (test_train_cli_starts_from_init_checkpoint):
    # a missing file raises as torch.load does in the JAX CLI
    with pytest.raises(FileNotFoundError):
        tcli.main(base + ["--init_checkpoint", str(tmp_path / "model.pt")])
    with pytest.raises(NotImplementedError, match="A.7"):
        tcli.main(base + ["--tensor_parallel", "2"])
    with pytest.raises(NotImplementedError, match="A.7"):
        tt.make_sharded_train_step(bart_tiny(), tt.TrainConfig(), mesh=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_train_state(bart_tiny(), tt.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(base[:-2])


@pytest.mark.parametrize("layout", ["fairseq", "hf"])
def test_train_cli_starts_from_init_checkpoint(tmp_path, layout):
    """``--init_checkpoint`` (a fairseq ``.pt``, or a HF directory): the
    CLI starts from the loaders' parameters (JAX's, bit for bit) and a zero
    optimizer state; at lr 0 two steps leave the parameters as loaded and
    count 2."""
    from seal_tpu.models import convert as jconvert
    from chip_smoke import port_state_dict
    from test_torch_loading import assert_trees_equal, seeded_tree

    tok, tok_path = _word_data(tmp_path, ["alpha beta gamma", "delta epsilon zeta"], 4)
    jcfg = jtiny(vocab_size=tok.vocab_size)
    tree = seeded_tree(jcfg, seed=2)
    if layout == "fairseq":
        path = str(tmp_path / "init.pt")
        torch.save({"model": port_state_dict(torch, tree, "fairseq")}, path)
        want = jconvert.load_fairseq_checkpoint(path, jcfg)
    else:
        path = str(tmp_path / "hf")
        (tmp_path / "hf").mkdir()
        torch.save(port_state_dict(torch, tree, "hf"), str(tmp_path / "hf" / "pytorch_model.bin"))
        want = jconvert.load_hf_checkpoint(path, jcfg)
    want = convert.params_from_jax(jax.device_get(want), None, device="cpu")
    save = str(tmp_path / "save")
    assert tcli.main([str(tmp_path / "train"), save, "--tokenizer", tok_path, "--backbone", "tiny",
                      "--batch_size", "4", "--max_update", "2", "--lr", "0", "--device", "cpu",
                      "--init_checkpoint", path]) == 0
    template = {"params": want, "opt_state": tt.make_optimizer(tt.TrainConfig()).init(want)}
    step, state = tckpt.restore_checkpoint(save, template)
    assert step == 2 and state["opt_state"].count == 2
    assert_trees_equal(state["params"], want)
