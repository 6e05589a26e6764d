"""The port's training path against the JAX reference's, on the CPU:
``LM.loss`` and its gradients, AdamW, checkpoints (both ways), the
Trainer and the launcher.

The reference makes the weights (``LM.init``); they reach the port as
numpy arrays through ``convert.lm_params_from_arrays``, and the port's
gradients go back through ``convert.lm_params_to_arrays`` to be held
leaf by leaf against ``jax.grad`` of the jit-ed reference loss.  Batches
come from the two packages' synthetic pipelines, which make the same
tokens for a seed and step.

Tolerances, fp32 (the reduced configs): the loss within 1e-5 relative and
each leaf's gradient within 1e-4 in relative norm (sums in another order
than XLA's through a few layers); the optimizer's parameters within
rtol = atol = 1e-6 after 5 steps (the same fp32 operations; the global
norm sums its leaves in another order), bf16 moments within one bf16
ulp; a checkpoint's leaves bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models.model import build as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import TrainConfig, Trainer
from torch_port_util import reference_compiled_here  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen1.5-0.5b", "llama4-scout-17b-a16e", "mamba2-1.3b",
         "jamba-1.5-large-398b", "minicpm3-4b", "whisper-base",
         "paligemma-3b"]
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def to_numpy(tree):
    """A reference pytree as numpy; bf16 leaves as their uint16 bits."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
    return jax.tree.map(leaf, tree)


def flat(tree, key=""):
    """``{"a/b": array}`` of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{key}/{k}" if key else k))
        return out
    return {key: np.asarray(tree)}


def models(arch, remat=False):
    """(reference LM, its params, port LM, carried params, port cfg)."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), remat=remat)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), remat=remat)
    jlm = jbuild(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params_from_arrays(tcfg, to_numpy(jparams),
                                            device="cpu")
    return jlm, jparams, build(tcfg), tparams, tcfg


def batches(cfg, step=0, seq=20, batch=2):
    """The same batch for both packages (odd length: the loss pads)."""
    jb = jpipe.add_modality_stubs(
        jpipe.SyntheticLM(cfg.vocab_size, seq, batch, seed=4).batch_at(step),
        cfg, step)
    tb = tpipe.add_modality_stubs(
        tpipe.SyntheticLM(cfg.vocab_size, seq, batch, seed=4).batch_at(step),
        cfg, step)
    return {k: jnp.asarray(v) for k, v in jb.items()}, tb


def port_loss_and_grads(lm, params, batch):
    leaves = O.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = lm.loss(params, batch)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss, metrics, O.tree_map(lambda p: by_leaf[id(p)], params)


def check_loss_and_grads(arch, remat):
    jlm, jparams, tlm, tparams, cfg = models(arch, remat)
    jb, tb = batches(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jparams, jb)
    tl, tm, tg = port_loss_and_grads(tlm, tparams, tb)
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert tm.keys() == jm.keys()
    for name in tm:
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    want = flat(to_numpy(jg))
    got = flat(convert.lm_params_to_arrays(tg))
    assert got.keys() == want.keys()
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + 1e-8, (key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``LM.loss`` and every parameter's gradient against the jit-ed
    reference's ``loss`` and ``jax.grad``: dense GQA, MoE (capacity
    dispatch and aux losses), SSM, the hybrid, MLA, the encoder-decoder
    and the VLM's prefix-LM."""
    check_loss_and_grads(arch, remat=False)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "llama4-scout-17b-a16e"])
def test_remat_loss_and_grads_match_reference(arch):
    """With ``remat`` each period, encoder layer and loss chunk runs under
    ``torch.utils.checkpoint``: the same loss and gradients as the
    reference's ``jax.checkpoint``."""
    check_loss_and_grads(arch, remat=True)


def test_loss_drops_the_vision_prefix_and_pads_labels():
    """A VLM's loss reads only the text positions (every label counts,
    none of the vision prefix's), and labels of -1 (the pad) count
    nowhere."""
    _, _, tlm, tparams, cfg = models("paligemma-3b")
    _, tb = batches(cfg, seq=cfg.loss_chunk + 5)
    loss, m = tlm.loss(tparams, tb)
    assert float(m["tokens"]) == tb["labels"].numel()
    cut = dict(tb, labels=tb["labels"].clone())
    cut["labels"][:, -5:] = -1
    _, mc = tlm.loss(tparams, cut)
    assert float(mc["tokens"]) == tb["labels"].numel() - 10
    assert float(mc["xent"]) != float(m["xent"])


# -- AdamW ------------------------------------------------------------------
def opt_tree(rng):
    """A small tree of the port's shape: a list of period dicts beside
    top-level leaves."""
    return {"embed": rng.normal(size=(6, 4)).astype(np.float32),
            "blocks": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)}
                       for _ in range(2)]}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_matches_reference_over_5_steps(moments):
    cfg = O.OptimizerConfig(lr=0.05, warmup_steps=2, total_steps=8,
                            grad_clip=0.5, moment_dtype=moments)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    tree = opt_tree(rng)
    # Copies: jax may alias a numpy buffer on the CPU, and the port
    # updates its tensors in place.
    tparams = O.tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    topt, jstate = O.init(cfg, tparams), jopt.init(jcfg, jparams)
    for step in range(5):
        g = opt_tree(rng)
        tparams, topt, tm = O.update(cfg, O.tree_map(torch.from_numpy, g),
                                     topt, tparams)
        jparams, jstate, jm = jopt.update(jcfg, jax.tree.map(jnp.asarray, g),
                                          jstate, jparams)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert topt["step"] == int(jstate["step"]) == 5
    assert topt["m"]["embed"].dtype == {"float32": torch.float32,
                                        "bfloat16": torch.bfloat16}[moments]
    tol = dict(rtol=1e-6, atol=1e-6) if moments == "float32" else \
        dict(rtol=2 ** -7, atol=1e-6)
    for name, t, j in (("params", tparams, jparams),
                       ("m", topt["m"], jstate["m"]),
                       ("v", topt["v"], jstate["v"])):
        got = flat(convert.lm_params_to_arrays(O.tree_map(
            lambda x: x.float(), t)))
        want = flat(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                 {**j, "blocks": jax.tree.map(
                                     lambda *xs: jnp.stack(xs), *j["blocks"])
                                  }))
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **(
                dict(rtol=1e-6, atol=1e-6) if name == "params" else tol),
                err_msg=f"{name}/{key}")


def test_schedule_matches_reference():
    cfg = O.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert O.schedule(cfg, step) == pytest.approx(
            float(jopt.schedule(jcfg, jnp.asarray(step))), rel=1e-6)


def quadratic_run(cfg, w, steps):
    params = {"w": torch.tensor(w)}
    opt = O.init(cfg, params)
    for _ in range(steps):
        params, opt, _ = O.update(cfg, {"w": 2 * params["w"]}, opt, params)
    return params, opt


def test_adamw_converges_quadratic():
    cfg = O.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, grad_clip=1e9)
    params, _ = quadratic_run(cfg, [5.0, -3.0], 200)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_reports_the_norm_before_clipping():
    cfg = O.OptimizerConfig(lr=1.0, warmup_steps=0, grad_clip=1.0,
                            weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, _, m = O.update(cfg, {"w": torch.full((4,), 1e6)},
                       O.init(cfg, params), params)
    assert float(m["grad_norm"]) > 1e5


def test_schedule_warmup_and_decay():
    cfg = O.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    assert O.schedule(cfg, 1) < O.schedule(cfg, 10) == 1.0
    assert abs(O.schedule(cfg, 100) - 0.1) < 1e-5


def test_bf16_moments_shapes_and_progress():
    cfg = O.OptimizerConfig(lr=0.05, warmup_steps=0,
                            moment_dtype="bfloat16", weight_decay=0.0)
    params, opt = quadratic_run(cfg, [2.0], 50)
    assert opt["m"]["w"].dtype == torch.bfloat16
    assert abs(float(params["w"][0])) < 1.0


def test_weight_decay_pulls_to_zero():
    cfg = O.OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.tensor([1.0])}
    p2, _, _ = O.update(cfg, {"w": torch.tensor([0.0])},
                        O.init(cfg, params), params)
    assert float(p2["w"][0]) < 1.0


def test_update_writes_in_place():
    """The port's one departure: parameters and moments are updated in
    place (the same tensors), not returned as new trees."""
    cfg = O.OptimizerConfig(lr=0.1, warmup_steps=0)
    params = {"w": torch.ones(3)}
    opt = O.init(cfg, params)
    ids = (id(params["w"]), id(opt["m"]["w"]), id(opt["v"]["w"]))
    params, opt, _ = O.update(cfg, {"w": torch.ones(3)}, opt, params)
    assert (id(params["w"]), id(opt["m"]["w"]), id(opt["v"]["w"])) == ids
    assert float(params["w"][0]) < 1.0 and float(opt["m"]["w"][0]) > 0.0


# -- the Trainer --------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = tconfigs.reduced_config("qwen1.5-0.5b")
    return cfg, build(cfg), tpipe.SyntheticLM(cfg.vocab_size, 32, 8, seed=3)


def test_loss_decreases(setup):
    cfg, lm, data = setup
    tc = TrainConfig(steps=25, log_every=5,
                     opt=O.OptimizerConfig(lr=1e-2, warmup_steps=5,
                                           total_steps=25))
    hist = Trainer(lm, data.batch_at, tc, device="cpu").run()
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.95
    assert {"loss", "xent", "grad_norm", "lr", "step", "time"} <= \
        hist[0].keys()


def test_checkpoint_restart_exact(setup):
    """Crash at step 20, restart, continue to 30: bitwise the parameters
    and moments of an uninterrupted 30-step run."""
    cfg, lm, data = setup
    opt = O.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=30)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a = Trainer(lm, data.batch_at, TrainConfig(
            steps=30, ckpt_dir=d1, ckpt_every=10, ckpt_async=False, opt=opt),
            device="cpu")
        a.run()
        Trainer(lm, data.batch_at, TrainConfig(
            steps=20, ckpt_dir=d2, ckpt_every=10, ckpt_async=False, opt=opt),
            device="cpu").run()
        b = Trainer(lm, data.batch_at, TrainConfig(
            steps=30, ckpt_dir=d2, ckpt_every=10, ckpt_async=False, opt=opt),
            device="cpu")
        assert b.step == 20 and b.opt_state["step"] == 20
        b.run()
        for xa, xb in zip(O.leaves([a.params, a.opt_state["m"],
                                    a.opt_state["v"]]),
                          O.leaves([b.params, b.opt_state["m"],
                                    b.opt_state["v"]])):
            assert torch.equal(xa, xb)


def test_trainer_refuses_a_mesh_and_a_missing_card(setup):
    cfg, lm, data = setup
    with pytest.raises(NotImplementedError, match="#8"):
        Trainer(lm, data.batch_at, TrainConfig(), mesh=object(),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(lm, data.batch_at, TrainConfig())


# -- checkpoints --------------------------------------------------------------
def test_checkpoint_gc_and_atomicity():
    with tempfile.TemporaryDirectory() as d:
        tree = {"x": np.arange(5.0)}
        for s in range(6):
            ckpt_lib.save(d, s, tree, keep=3)
        files = sorted(os.listdir(d))
        assert len(files) == 3 and files[-1] == "step_00000005.npz"
        assert not any(f.startswith("tmp") for f in files)
        restored, step = ckpt_lib.restore(d, {"x": np.zeros(5)})
        assert step == 5
        np.testing.assert_array_equal(restored["x"], np.arange(5.0))


def test_async_save_completes():
    with tempfile.TemporaryDirectory() as d:
        t = ckpt_lib.save_async(d, 7, {"w": torch.ones((64, 64))})
        t.join()
        assert ckpt_lib.latest_step(d) == 7
        ckpt_lib.wait_pending()


def test_bf16_tree_round_trips_bit_for_bit():
    """bf16 leaves (top level and in a list of period dicts) are written
    as ``|V2``, the bytes the reference writes, and come back bit for
    bit."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 16, (2, 5, 3)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80      # no NaN or inf patterns
    tree = {"embed": torch.from_numpy(bits[0].view(np.int16)).view(
        torch.bfloat16),
        "blocks": [{"w": torch.from_numpy(bits[i].view(np.int16)).view(
            torch.bfloat16)} for i in range(2)],
        "step": 3}
    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save(d, 1, tree)
        with np.load(os.path.join(d, "step_00000001.npz")) as f:
            assert f["blocks/w"].dtype == np.dtype("V2")
            assert f["blocks/w"].shape == (2, 5, 3)
        target = {"embed": torch.zeros(5, 3, dtype=torch.bfloat16),
                  "blocks": [{"w": torch.zeros(5, 3, dtype=torch.bfloat16)}
                             for _ in range(2)], "step": 0}
        got, step = ckpt_lib.restore(d, target)
    assert step == 1 and got["step"] == 3
    for a, b in zip(O.leaves(got), O.leaves(tree)):
        if torch.is_tensor(a):
            assert a.dtype == torch.bfloat16 and torch.equal(
                a.view(torch.int16), b.view(torch.int16))


def test_reference_bf16_file_restores_in_the_port():
    """The reference writes bf16 leaves it cannot restore itself; the
    port reads them as their bits."""
    w = jnp.asarray(np.random.default_rng(2).normal(size=(4, 3)),
                    jnp.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 5, {"w": w})
        got, _ = ckpt_lib.restore(d, {"w": torch.zeros(
            4, 3, dtype=torch.bfloat16)})
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(w).view(np.uint16))


def ref_trainer(cfg, d, steps, data):
    jcfg = jconfigs.reduced_config(cfg.arch_id)
    return JTrainer(jbuild(jcfg), data.batch_at, JTrainConfig(
        steps=steps, ckpt_dir=d, ckpt_every=3, ckpt_async=False, log_every=1,
        opt=jopt.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=8)))


def test_reference_checkpoint_continues_in_the_port():
    """The reference Trainer saves after 3 steps; the port's Trainer
    restores it and takes step 4, whose loss is the reference's step 4
    within 1e-5 relative."""
    cfg = tconfigs.reduced_config("qwen1.5-0.5b")
    jdata = jpipe.SyntheticLM(cfg.vocab_size, 24, 4, seed=6)
    tdata = tpipe.SyntheticLM(cfg.vocab_size, 24, 4, seed=6)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        ref_trainer(cfg, d, 3, jdata).run()
        want = ref_trainer(cfg, d2, 4, jdata).run()[-1]
        tr = Trainer(build(cfg), tdata.batch_at, TrainConfig(
            steps=4, ckpt_dir=d, ckpt_every=50, log_every=1,
            opt=O.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=8)),
            device="cpu")
        assert tr.step == 3 and tr.opt_state["step"] == 3
        got = tr.run()[-1]
    assert got["step"] == want["step"] == 4
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_port_checkpoint_restores_in_the_reference():
    """The port saves its fp32 state; the reference's ``restore`` reads
    the file into its own Trainer's tree, leaf for leaf."""
    cfg = tconfigs.reduced_config("qwen1.5-0.5b")
    tdata = tpipe.SyntheticLM(cfg.vocab_size, 16, 2, seed=7)
    jdata = jpipe.SyntheticLM(cfg.vocab_size, 16, 2, seed=7)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(build(cfg), tdata.batch_at, TrainConfig(
            steps=2, ckpt_dir=d, ckpt_every=2, ckpt_async=False),
            device="cpu")
        tr.run()
        jt = ref_trainer(cfg, None, 2, jdata)
        target = {"params": jt.params, "opt": jt.opt_state,
                  "meta": {"step": 0}}
        tree, step = jckpt.restore(d, target)
    assert step == 2 and int(tree["meta"]["step"]) == 2
    assert int(tree["opt"]["step"]) == 2
    want = flat(convert.lm_params_to_arrays(
        {"params": tr.params, "m": tr.opt_state["m"],
         "v": tr.opt_state["v"]}))
    got = flat({"params": to_numpy(tree["params"]),
                "m": to_numpy(tree["opt"]["m"]),
                "v": to_numpy(tree["opt"]["v"])})
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_params_round_trip_through_convert():
    """``lm_params_to_arrays`` is the inverse of ``lm_params_from_arrays``
    (periods and encoder layers stacked again; bf16 as uint16 bits)."""
    jcfg = dataclasses.replace(jconfigs.reduced_config("whisper-base"),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.reduced_config("whisper-base"),
                               param_dtype="bfloat16")
    want = flat(to_numpy(jbuild(jcfg).init(jax.random.key(1))))
    got = flat(convert.lm_params_to_arrays(convert.lm_params_from_arrays(
        tcfg, to_numpy(jbuild(jcfg).init(jax.random.key(1))),
        device="cpu")))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


# -- the launcher -------------------------------------------------------------
def test_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "4",
         "--seq", "32", "--global-batch", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "step     4  loss" in proc.stdout


def test_launcher_main_returns_its_trainer_and_refuses_a_mesh():
    seen = []
    tr = tlaunch.main(["--arch", "whisper-base", "--reduced", "--device",
                       "cpu", "--steps", "2", "--seq", "12",
                       "--global-batch", "2"],
                      on_step=lambda t: seen.append(float(t.metrics["loss"])))
    assert tr.step == 2 and len(seen) == 2
    assert all(np.isfinite(seen))
    for flag in (["--host-devices", "4"], ["--data-axis", "2"],
                 ["--model-axis", "2"]):
        with pytest.raises(NotImplementedError, match="#8"):
            tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced", *flag])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced"])
