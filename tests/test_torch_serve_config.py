"""The serving knobs of the port (tpu_ddp_torch/utils/config.py,
serve/engine.py, launch.py) held to the JAX package's.

Every ``TPU_DDP_*`` env knob that tpu_ddp/utils/config.py reads is either
read by the port's ``TrainConfig`` with the same validation (the same
``ValueError`` message on junk, the same value into ``ServeEngine``) or
refused with ``NotImplementedError`` naming its ROADMAP item: none is
ignored. The launcher exports the serving flags as their env knobs.
"""

import argparse
import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.transformer import make_transformer as jax_make
from tpu_ddp.serve import ServeEngine as JaxServeEngine
from tpu_ddp.utils.config import TrainConfig as JaxConfig
from tpu_ddp_torch import launch
from tpu_ddp_torch.models.transformer import make_transformer
from tpu_ddp_torch.serve.engine import ServeEngine
from tpu_ddp_torch.utils import config as tcfg
from tpu_ddp_torch.utils.config import TrainConfig

REPO = pathlib.Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's own thread
    pool on top of them oversubscribes the cores (its threads spin), and
    these tiny shapes gain nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _knobs(path):
    """The TPU_DDP_* names a config module reads (string constants)."""
    tree = ast.parse((REPO / path).read_text())
    return sorted({n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and re.fullmatch(r"TPU_DDP_[A-Z0-9_]+", n.value)})


JAX_KNOBS = _knobs("tpu_ddp/utils/config.py")
PORT_READS = set(_knobs("tpu_ddp_torch/utils/config.py")) \
    - set(tcfg._UNPORTED_ENV)
# A value that is not the default for each refused knob.
NON_DEFAULT = {"TPU_DDP_FLEET_HEALTH": "0", "TPU_DDP_FLEET_ROLES": "disagg",
               "TPU_DDP_ROUTER_POLICY": "prefix-affinity",
               "TPU_DDP_KV_WIRE": "int8", "TPU_DDP_FLEET_AUTOSCALE": "1",
               "TPU_DDP_PP_SCHEDULE": "1f1b",
               "TPU_DDP_PUBLISH_WIRE": "bf16",
               "TPU_DDP_DILOCO_OUTER_WIRE": "int8",
               "TPU_DDP_GRAD_COMPRESS": "int8", "TPU_DDP_REMAT": "blocks",
               "TPU_DDP_ACT_DTYPE": "bf16",
               "TPU_DDP_AUDIT": "warn", "TPU_DDP_ELASTIC_DIR": "/x"}


@pytest.fixture
def clean_env(monkeypatch):
    for name in set(JAX_KNOBS) | set(tcfg._UNPORTED_ENV):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_every_jax_knob_is_read_or_refused():
    assert len(JAX_KNOBS) > 50
    missing = [k for k in JAX_KNOBS
               if k not in PORT_READS and k not in tcfg._UNPORTED_ENV]
    assert not missing, f"JAX knobs the port neither reads nor refuses: " \
                        f"{missing}"
    for name, (_, item) in tcfg._UNPORTED_ENV.items():
        assert re.match(r"item \d+(\.\d+[a-z]?)? \(", item), (name, item)


# Knobs this test refused until their item was ported; each keeps its
# case, which now holds that the knob is read instead (items 10.8 and
# 11a): env name -> (TrainConfig field, the value NON_DEFAULT gives).
PORTED_SINCE = {"TPU_DDP_MOE_EXPERTS": ("moe_experts", 7),
                "TPU_DDP_MOE_TOP_K": ("moe_top_k", 7),
                "TPU_DDP_MOE_CAPACITY": ("moe_capacity", 7),
                "TPU_DDP_ROUTER_POLICY": ("router_policy",
                                          "prefix-affinity"),
                "TPU_DDP_KV_WIRE": ("kv_wire", "int8"),
                "TPU_DDP_FLEET_HEALTH": ("fleet_health", False),
                "TPU_DDP_FLEET_HEALTH_BACKOFF_MS": ("fleet_probe_backoff_ms",
                                                    7.0),
                "TPU_DDP_FLEET_HEALTH_DEADLINE_MS": ("fleet_step_deadline_ms",
                                                     7.0),
                "TPU_DDP_FLEET_RETRY_BUDGET": ("fleet_retry_budget", 7),
                "TPU_DDP_FLEET_AUTOSCALE": ("fleet_autoscale", True),
                "TPU_DDP_SCALE_COOLDOWN_MS": ("scale_cooldown_ms", 7.0)}


@pytest.mark.parametrize("name", sorted(set(tcfg._UNPORTED_ENV)
                                        | set(PORTED_SINCE)))
def test_unported_knob_raises_naming_its_item(clean_env, name):
    clean_env.setenv(name, NON_DEFAULT.get(name, "7"))
    if name in PORTED_SINCE:
        tcfg.refuse_unported_env()
        field, value = PORTED_SINCE[name]
        assert getattr(TrainConfig(), field) == value
        return
    item = tcfg._UNPORTED_ENV[name][1]
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        tcfg.refuse_unported_env()
    model = make_transformer("TransformerLM-tiny", max_seq_len=32,
                             compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        ServeEngine(model, model.init(torch.Generator().manual_seed(0)),
                    device="cpu")


@pytest.mark.parametrize("name", sorted(set(tcfg._UNPORTED_ENV)
                                        | set(PORTED_SINCE)))
def test_unported_knob_at_its_default_passes(clean_env, name):
    if name in PORTED_SINCE:
        field = PORTED_SINCE[name][0]
        default = getattr(TrainConfig(), field)
        clean_env.setenv(name, str(default))
        tcfg.refuse_unported_env()
        assert getattr(TrainConfig(), field) == default
        return
    off = tcfg._UNPORTED_ENV[name][0]
    if off:
        clean_env.setenv(name, off[0])
    tcfg.refuse_unported_env()


SERVING_ENV = {"TPU_DDP_SPEC_K": "3", "TPU_DDP_SPEC_DRAFT": "self-1",
               "TPU_DDP_PREFIX_CACHE": "1",
               "TPU_DDP_TENANT_CLASSES": "gold=3:50,bronze=1:0:400",
               "TPU_DDP_SERVE_QUEUE_LIMIT": "5",
               "TPU_DDP_SERVE_SHED_MS": "12.5", "TPU_DDP_KV_TIERS": "3",
               "TPU_DDP_KV_COLD_DTYPE": "bf16",
               "TPU_DDP_DECODE_QUANT": "int8"}


def test_serving_knobs_flow_into_the_engine_as_in_jax(clean_env):
    for k, v in SERVING_ENV.items():
        clean_env.setenv(k, v)
    jcfg, tcfg_ = JaxConfig(), TrainConfig()
    fields = ("spec_k", "spec_draft", "prefix_cache", "tenant_classes",
              "serve_queue_limit", "serve_shed_ms", "kv_tiers",
              "kv_cold_dtype", "cp_prefill", "decode_quant")
    assert {f: getattr(tcfg_, f) for f in fields} == \
        {f: getattr(jcfg, f) for f in fields}
    jm = jax_make("TransformerLM-tiny", max_seq_len=32,
                  compute_dtype=jnp.float32)
    tm = make_transformer("TransformerLM-tiny", max_seq_len=32,
                          compute_dtype=torch.float32)
    jeng = JaxServeEngine(jm, jm.init(jax.random.key(0)), num_slots=2,
                          block_size=8, prefill_chunk=8)
    teng = ServeEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                       num_slots=2, block_size=8, prefill_chunk=8,
                       device="cpu")
    for attr in ("spec_k", "spec_draft", "decode_quant", "kv_tiers",
                 "kv_cold_dtype", "queue_limit", "shed_ms", "cp_prefill"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert (teng.prefix is None) == (jeng.prefix is None) is False
    assert {k: (c.weight, c.deadline_ms, c.token_budget)
            for k, c in teng.tenants.items()} == \
        {k: (c.weight, c.deadline_ms, c.token_budget)
         for k, c in jeng.tenants.items()}
    assert teng.pool.tiers == jeng.pool.tiers == 3
    assert teng.draft_layers == 1


@pytest.mark.parametrize("name,value", [
    ("TPU_DDP_SPEC_K", "-1"), ("TPU_DDP_SPEC_K", "two"),
    ("TPU_DDP_SPEC_DRAFT", "self-0"), ("TPU_DDP_SPEC_DRAFT", "medusa"),
    ("TPU_DDP_PREFIX_CACHE", "maybe"),
    ("TPU_DDP_TENANT_CLASSES", "gold"), ("TPU_DDP_TENANT_CLASSES", "g=0"),
    ("TPU_DDP_TENANT_CLASSES", "g=1:x"), ("TPU_DDP_TENANT_CLASSES",
                                          "g=1:2:3:4"),
    ("TPU_DDP_SERVE_QUEUE_LIMIT", "-2"), ("TPU_DDP_SERVE_QUEUE_LIMIT", "x"),
    ("TPU_DDP_SERVE_SHED_MS", "-1"), ("TPU_DDP_KV_TIERS", "4"),
    ("TPU_DDP_KV_TIERS", "x"), ("TPU_DDP_KV_COLD_DTYPE", "fp8"),
    ("TPU_DDP_CP_PREFILL", "sideways"), ("TPU_DDP_DECODE_QUANT", "int4")])
def test_junk_is_rejected_with_the_jax_message(clean_env, name, value):
    clean_env.setenv(name, value)
    with pytest.raises(ValueError) as jerr:
        JaxConfig()
    with pytest.raises(ValueError) as terr:
        TrainConfig()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_cp_prefill_raises_naming_item_10_5(clean_env, mode):
    """Context-parallel prefill is ported: the config takes each mode as
    the JAX config does, and an engine given no sp group of >= 2 ranks
    raises the JAX engine's error (tests/test_torch_cp_prefill.py runs
    the sharded engine)."""
    clean_env.setenv("TPU_DDP_CP_PREFILL", mode)
    assert TrainConfig().cp_prefill == JaxConfig().cp_prefill == mode
    tm = make_transformer("TransformerLM-tiny", max_seq_len=32,
                          compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="'sp' axis of extent >= 2"):
        ServeEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                    device="cpu")


def test_engine_refuses_mesh_and_sharded_checkpoints(clean_env, tmp_path):
    """A device mesh (``mesh=``, ``shard_devices=``) raises, naming the
    port's per-process form, ``tp_group``; a parameter budget serves
    (alone here, with no process group: tests/test_torch_serve_tp.py
    routes it over a tp group)."""
    from tpu_ddp_torch.convert import params_to_jax
    from tpu_ddp_torch.utils import checkpoint as ckpt
    tm = make_transformer("TransformerLM-tiny", max_seq_len=32,
                          compute_dtype=torch.float32)
    params = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="pass tp_group"):
        ServeEngine(tm, params, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="'sp' axis of extent >= 2"):
        ServeEngine(tm, params, cp_prefill="ring", device="cpu")
    with pytest.raises(NotImplementedError, match="pass tp_group"):
        ServeEngine.from_checkpoint(tm, str(tmp_path), device="cpu",
                                    shard_devices=["cpu"])
    ckpt.save_checkpoint(str(tmp_path), {"params": params_to_jax(params),
                                         "step": np.int64(0)}, step=0)
    want = ServeEngine(tm, params, device="cpu", num_slots=2)
    for budget in (1, 10 ** 12):
        eng = ServeEngine.from_checkpoint(tm, str(tmp_path), device="cpu",
                                          param_budget_bytes=budget,
                                          num_slots=2)
        assert eng.tp == 1
        got = [eng.submit([1, 2, 3], 4), want.submit([1, 2, 3], 4)]
        eng.run()
        want.run()
        assert got[0].tokens == got[1].tokens


def _parse(argv):
    p = argparse.ArgumentParser()
    launch._serving_flags(p)
    args = p.parse_args(argv)
    return launch._serving_env(p, args)


def test_launcher_accepts_decode_quant_and_the_serving_flags():
    argv = ["--decode-quant", "int8", "--spec-k", "4", "--spec-draft",
            "self-2", "--tenant-classes", "gold=3,bronze=1",
            "--serve-queue-limit", "8", "--serve-shed-ms", "250",
            "--kv-tiers", "2", "--kv-cold-dtype", "bf16"]
    launch._refuse_unported(argv)
    assert _parse(argv) == {
        "TPU_DDP_DECODE_QUANT": "int8", "TPU_DDP_SPEC_K": "4",
        "TPU_DDP_SPEC_DRAFT": "self-2",
        "TPU_DDP_TENANT_CLASSES": "gold=3,bronze=1",
        "TPU_DDP_SERVE_QUEUE_LIMIT": "8", "TPU_DDP_SERVE_SHED_MS": "250.0",
        "TPU_DDP_KV_TIERS": "2", "TPU_DDP_KV_COLD_DTYPE": "bf16"}
    assert _parse([]) == {}


@pytest.mark.parametrize("argv", [["--spec-k", "-1"],
                                  ["--spec-draft", "self-0"],
                                  ["--tenant-classes", "gold"],
                                  ["--serve-queue-limit", "-3"],
                                  ["--decode-quant", "int4"],
                                  ["--kv-tiers", "5"]])
def test_launcher_rejects_junk_serving_flags(argv):
    with pytest.raises(SystemExit):
        _parse(argv)


def test_launcher_still_refuses_cp_prefill():
    """Ported: the launcher takes --cp-prefill and sets
    TPU_DDP_CP_PREFILL for every rank, as the JAX launcher does; a mode
    outside its choices is an argparse error."""
    launch._refuse_unported(["--cp-prefill", "ring"])
    for mode in ("off", "ring", "ulysses"):
        assert _parse(["--cp-prefill", mode]) == {
            "TPU_DDP_CP_PREFILL": mode}
    with pytest.raises(SystemExit):
        _parse(["--cp-prefill", "dp"])


def test_launcher_passes_the_serving_env_to_every_rank(monkeypatch):
    seen = {}

    def fake(part, nproc, **kw):
        seen.update(kw)
        return launch.LaunchResult()

    monkeypatch.setattr(launch, "launch_elastic", fake)
    assert launch.main(["part1", "--nproc", "1", "--decode-quant", "int8",
                        "--spec-k", "2"]) == 0
    assert seen["env"] == {"TPU_DDP_DECODE_QUANT": "int8",
                           "TPU_DDP_SPEC_K": "2"}
    assert launch.main(["part1", "--nproc", "1"]) == 0
    assert seen["env"] is None


def test_engine_takes_every_argument_the_jax_engine_takes():
    import inspect
    for name in ("__init__", "from_checkpoint", "submit"):
        want = set(inspect.signature(getattr(JaxServeEngine, name))
                   .parameters)
        got = set(inspect.signature(getattr(ServeEngine, name)).parameters)
        assert want <= got, (name, sorted(want - got))
    for name in ("cancel", "step", "run", "swap_params", "outstanding",
                 "outstanding_by_tenant", "prefix_cached_len",
                 "accounting_ok", "tenant_accounting_ok", "tenant_stats",
                 "spec_stats", "drain"):
        assert callable(getattr(ServeEngine, name)), name
