"""The single-card training recipe in the port's two trainers held
against the JAX package's: ``LMTrainer`` with Adafactor, AdamW or SGD, a
schedule, global-norm clipping, the chunked-vocab loss and a memory
policy; the VGG ``Trainer`` with clipping, remat and scheduled SGD; the
optimizer states of both in the JAX checkpoint format, both ways; and
the knobs' env variables and launcher flags.

Tolerances, all f32 on the same weights and batches: LM losses within
1e-5 relative; parameters within 1e-4 (AdamW's step is about +-lr where a
gradient is near 0, so a last-bit difference moves it by up to lr; see
tests/test_torch_lm.py) and Adafactor's second-moment slots within rtol
1e-4 / atol 1e-10 (means summed in another order, compounded over three
steps). VGG parameters within rtol 1e-4 / atol 1e-5, as
tests/test_torch_train.py. Checkpoints: bit equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models import make_transformer as jax_make
from tpu_ddp.models.vgg import VGGModel as JaxVGG
from tpu_ddp.ops import optim as jopt
from tpu_ddp.parallel.mesh import make_mesh
from tpu_ddp.train.engine import Trainer as JaxTrainer
from tpu_ddp.train.lm import LMTrainer as JaxLMTrainer
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch import launch
from tpu_ddp_torch.convert import image_params_from_jax, params_from_jax
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.models.vgg import VGGModel
from tpu_ddp_torch.ops import optim
from tpu_ddp_torch.parallel.redistribute import ShardingPlan
from tpu_ddp_torch.train.engine import Trainer, TrainState
from tpu_ddp_torch.train.lm import LMTrainer, make_lm_batch
from tpu_ddp_torch.utils.config import TrainConfig

SEQ = 32
TINY = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
KNOBS = dict(pallas_sgd=True, pallas_bn=True, compute_dtype="float32")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _opts(name):
    """(JAX optimizer, port optimizer) of one recipe."""
    if name == "adafactor":
        return (jopt.Adafactor(min_dim_size_to_factor=8),
                optim.Adafactor(min_dim_size_to_factor=8))
    if name == "adafactor_sched_b1":
        return (jopt.Adafactor(min_dim_size_to_factor=8, b1=0.9,
                               learning_rate=jopt.warmup_cosine(1e-2, 2, 8)),
                optim.Adafactor(min_dim_size_to_factor=8, b1=0.9,
                                learning_rate=optim.warmup_cosine(
                                    1e-2, 2, 8)))
    if name == "adamw_sched":
        return (jopt.AdamW(learning_rate=jopt.warmup_cosine(1e-3, 2, 8)),
                optim.AdamW(learning_rate=optim.warmup_cosine(1e-3, 2, 8)))
    return (jopt.SGD(learning_rate=jopt.warmup_cosine(0.05, 2, 8)),
            optim.SGD(learning_rate=optim.warmup_cosine(0.05, 2, 8)))


def _lm_pair(name, remat="none", clip=0.5, chunk=256):
    jo, to = _opts(name)
    kw = dict(max_seq_len=SEQ, use_flash=True, remat=remat)
    jm = jax_make("TransformerLM-tiny", compute_dtype=jnp.float32, **kw)
    tm = make_transformer("TransformerLM-tiny", compute_dtype=torch.float32,
                          **kw)
    jt = JaxLMTrainer(jm, make_mesh(jax.devices()[:1]), optimizer=jo,
                      vocab_chunk=chunk, clip_grad_norm=clip)
    tt = LMTrainer(tm, device="cpu", optimizer=to, vocab_chunk=chunk,
                   clip_grad_norm=clip)
    return jt, tt


def _lm_batch(seed=3):
    return make_lm_batch(np.random.default_rng(seed).integers(
        0, 1024, size=(4, SEQ + 1)))


@pytest.mark.parametrize("name,remat", [
    ("adafactor", "dots"), ("adafactor_sched_b1", "none"),
    ("adamw_sched", "blocks"), ("sgd_sched", "none")])
def test_lm_recipe_matches_jax(name, remat):
    """Three steps: the optimizer, clip 0.5 (it scales every step here),
    the chunked loss (vocab 1024 in chunks of 256) and a remat mode."""
    jt, tt = _lm_pair(name, remat)
    js = jt.init_state(seed=0)
    ts = tt.init_state(params=params_from_jax(tt.model, _host(js.params),
                                              device="cpu"))
    x, y = _lm_batch()
    jx, jy = jt.put_batch(x, y)
    tx, ty = tt.put_batch(x, y)
    jl, tl = [], []
    for _ in range(3):
        js, loss = jt.train_step(js, jx, jy)
        jl.append(float(np.mean(np.asarray(loss))))
        ts, loss = tt.train_step(ts, tx, ty)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    host = tt.state_to_host(ts)
    for g, w in zip(jax.tree.leaves(host["params"]),
                    jax.tree.leaves(jt.params_to_host(js))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    jo = _host(js.opt_state)
    assert sorted(host["opt_state"]) == sorted(jo)
    assert int(host["opt_state"]["count"]) == int(jo["count"]) == 3
    for k in jo:
        if k == "count":
            continue
        tol = (dict(rtol=1e-4, atol=1e-10) if k in ("vr", "vc", "v")
               else dict(rtol=1e-4, atol=1e-4))
        for g, w in zip(jax.tree.leaves(host["opt_state"][k]),
                        jax.tree.leaves(jo[k])):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


def test_chunked_and_dense_losses_agree_in_the_trainer():
    """The same two steps with ``vocab_chunk`` 0 and 256."""
    out = []
    for chunk in (0, 256):
        tm = make_transformer("TransformerLM-tiny", max_seq_len=SEQ,
                              compute_dtype=torch.float32)
        tt = LMTrainer(tm, device="cpu", vocab_chunk=chunk,
                       optimizer=optim.AdamW(eps=1e-3))
        s = tt.init_state(seed=0)
        x, y = tt.put_batch(*_lm_batch())
        losses = []
        for _ in range(2):
            s, loss = tt.train_step(s, x, y)
            losses.append(float(loss))
        out.append(losses)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)
    with pytest.raises(ValueError, match="vocab_chunk"):
        LMTrainer(tm, device="cpu", vocab_chunk=300)
    with pytest.raises(ValueError, match="clip_grad_norm"):
        LMTrainer(tm, device="cpu", clip_grad_norm=0.0)
    with pytest.raises(TypeError, match="AdamW, Adafactor or SGD"):
        LMTrainer(tm, device="cpu", optimizer=object())


def _vgg_pair(remat="none", clip=None, lr=None, pallas_sgd=True):
    knobs = dict(KNOBS, remat=remat, pallas_sgd=pallas_sgd)
    jcfg, tcfg = JaxConfig(**knobs), TrainConfig(**knobs)
    if lr is not None:
        jcfg.learning_rate = jopt.warmup_cosine(*lr)
        tcfg.learning_rate = optim.warmup_cosine(*lr)
    jm = JaxVGG(name="tiny", cfg=TINY, compute_dtype=jnp.float32,
                use_pallas_bn=True)
    jt = JaxTrainer(jm, jcfg, strategy="none", clip_grad_norm=clip)
    tm = VGGModel("tiny", TINY, compute_dtype=torch.float32,
                  use_pallas_bn=True)
    tt = Trainer(tm, tcfg, device="cpu", clip_grad_norm=clip)
    js = jt.init_state(0)
    tm.load_state_dict(image_params_from_jax(tm, _host(js.params),
                                           device="cpu"))
    # The JAX weights in place of the trainer's own init.
    params = list(tm.parameters())
    ts = TrainState(params=params, opt_state=tt.optimizer.init(params))
    return jt, js, tt, ts


def _vgg_batches(n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=4).astype(np.int64))
            for _ in range(n)]


def _vgg_steps(jt, js, tt, ts, batches):
    for x, y in batches:
        xb, yb, wb = jt.put_batch(x, y.astype(np.int32))
        js, _ = jt.train_step(js, xb, yb, wb)
        ts, _ = tt.train_step(ts, torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(y))
    return js, ts


@pytest.mark.parametrize("remat,clip,lr", [
    ("blocks", 0.5, None), ("conv_stages", 0.5, None),
    ("none", None, (0.1, 1, 6)), ("blocks", 1.0, (0.1, 1, 6))])
def test_vgg_trainer_recipe_matches_jax(remat, clip, lr):
    """Three steps of the tiny VGG with both kernel knobs (the SGD one
    off under a schedule: the kernel takes a static lr), a remat mode,
    clipping and a schedule."""
    jt, js, tt, ts = _vgg_pair(remat, clip, lr, pallas_sgd=lr is None)
    assert tt.model.remat == remat
    js, ts = _vgg_steps(jt, js, tt, ts, _vgg_batches())
    host = tt.state_to_host(ts)
    jhost = _host({"params": js.params, "opt_state": js.opt_state})
    for g, w in zip(jax.tree.leaves(host["params"]),
                    jax.tree.leaves(jhost["params"])):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert sorted(host["opt_state"]) == sorted(jhost["opt_state"])
    if lr is not None:
        assert int(host["opt_state"]["count"]) == int(
            jhost["opt_state"]["count"]) == 3


def test_vgg_scheduled_sgd_skips_without_advancing(monkeypatch):
    """The guard's skipped step leaves the device count where it was, so
    the schedule resumes at the same step."""
    _, _, tt, ts = _vgg_pair("none", None, (0.1, 1, 6), pallas_sgd=False)
    (x, y), = _vgg_batches(1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ts, _ = tt.train_step(ts, xt, torch.from_numpy(y))
    assert int(ts.opt_state["count"]) == 1
    before = [p.detach().clone() for p in ts.params]
    ts, _ = tt.train_step(ts, torch.full_like(xt, float("nan")),
                          torch.from_numpy(y))
    assert tt.last_step_skipped()
    assert int(ts.opt_state["count"]) == 1 and ts.step == 2
    for a, b in zip(before, ts.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adafactor", "adafactor_sched_b1",
                                  "sgd_sched"])
def test_lm_optimizer_checkpoints_cross_the_packages(tmp_path, name):
    """A JAX save restores in the port and a port save in JAX, bit for
    bit (Adafactor's reduced slots and (1,) placeholders included), with
    equal plan files; the next step then agrees."""
    jt, tt = _lm_pair(name)
    js = jt.init_state(seed=0)
    x, y = _lm_batch()
    jx, jy = jt.put_batch(x, y)
    for _ in range(2):
        js, _ = jt.train_step(js, jx, jy)
    jt.save_checkpoint(str(tmp_path / "jax"), js)
    assert ShardingPlan.load(str(tmp_path / "jax")) == tt.sharding_plan()
    ts = tt.restore_checkpoint(str(tmp_path / "jax"))
    host = tt.state_to_host(ts)
    want = _host({"opt_state": js.opt_state, "params": js.params})
    for part in ("opt_state", "params"):
        flat = jax.tree_util.tree_flatten_with_path(want[part])[0]
        got = jax.tree.leaves(host[part])
        assert len(flat) == len(got)
        for (path, w), g in zip(flat, got):
            np.testing.assert_array_equal(
                g, w, err_msg=f"{part}{jax.tree_util.keystr(path)}")
    tt.save_checkpoint(str(tmp_path / "port"), ts)
    back = jt.restore_checkpoint(str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(_host(back.opt_state)),
                    jax.tree.leaves(want["opt_state"])):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / "port" / "sharding_plan.json").read_text() == (
        tmp_path / "jax" / "sharding_plan.json").read_text()
    js, jl = jt.train_step(back, jx, jy)
    ts, tl = tt.train_step(ts, *tt.put_batch(x, y))
    np.testing.assert_allclose(float(tl), float(np.mean(np.asarray(jl))),
                               rtol=1e-5)


def test_vgg_scheduled_sgd_checkpoint_crosses_the_packages(tmp_path):
    jt, js, tt, ts = _vgg_pair("none", None, (0.1, 1, 6), pallas_sgd=False)
    js, ts = _vgg_steps(jt, js, tt, ts, _vgg_batches(2))
    tt.save_checkpoint(str(tmp_path), ts)
    back = jt.restore_checkpoint(str(tmp_path))
    assert int(back.opt_state["count"]) == 2
    ts2 = tt.restore_checkpoint(str(tmp_path))
    assert ts2.opt_state["count"].dtype == torch.int32
    assert int(ts2.opt_state["count"]) == 2 and ts2.step == 2


@pytest.mark.parametrize("remat,act", [("blocks", "bf16"),
                                       ("conv_stages", "f32"),
                                       ("dots", "compute")])
def test_memory_env_and_flags_match_jax(monkeypatch, remat, act):
    monkeypatch.setenv("TPU_DDP_REMAT", remat)
    monkeypatch.setenv("TPU_DDP_ACT_DTYPE", act)
    j, t = JaxConfig(), TrainConfig()
    assert (t.remat, t.act_dtype) == (j.remat, j.act_dtype) == (remat, act)
    # The trainer imprints the config on the model.
    tr = Trainer(VGGModel("tiny", TINY, use_pallas_bn=True),
                 TrainConfig(pallas_bn=True), device="cpu")
    assert (tr.model.remat, tr.model.act_dtype) == (remat, act)
    seen = {}
    monkeypatch.setattr(launch, "launch_elastic",
                        lambda part, nproc, **kw: seen.update(kw)
                        or launch.LaunchResult())
    assert launch.main(["part1", "--nproc", "1", "--remat", remat,
                        "--act-dtype", act]) == 0
    assert seen["env"] == {"TPU_DDP_REMAT": remat, "TPU_DDP_ACT_DTYPE": act}


@pytest.mark.parametrize("name,value", [("TPU_DDP_REMAT", "all"),
                                        ("TPU_DDP_ACT_DTYPE", "fp8")])
def test_bad_memory_env_raises_like_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    for cfg in (JaxConfig, TrainConfig):
        with pytest.raises(ValueError, match=name):
            cfg()
    with pytest.raises(SystemExit):
        launch.main(["part1", "--nproc", "1",
                     "--remat" if "REMAT" in name else "--act-dtype",
                     value])


def test_clip_needs_a_positive_norm():
    with pytest.raises(ValueError, match="clip_grad_norm"):
        Trainer(VGGModel("tiny", TINY, use_pallas_bn=True),
                TrainConfig(pallas_bn=True), device="cpu",
                clip_grad_norm=-1.0)
