"""The port's config system (``mmlearn_tpu_torch.conf``) on the CPU: a
counterpart of each test of ``tests/conf/test_config_system.py``, the port's
own schema and optimizer registrations, and every port experiment YAML
composed to the JAX package's composition of its JAX counterpart, once the
target names are mapped (``mmlearn_tpu.`` and the root ``projects.`` to the
port's modules, ``optax.adamw`` to ``torch.optim.AdamW`` with its
``learning_rate`` as ``lr``; ``scan_blocks``, an XLA layout, left out; an
``MLP`` head's ``in_dim``, which flax infers, stated)."""

import os

import pytest
import yaml

from mmlearn_tpu_torch.conf import (
    MISSING,
    ConfigError,
    builds,
    compose,
    instantiate,
    merge,
    resolve_interpolations,
    store,
)


class _Widget:
    def __init__(self, size: int, name: str = "w", scale: float = 1.0):
        self.size = size
        self.name = name
        self.scale = scale


def test_builds_populates_signature():
    node = builds(_Widget)
    assert node["_target_"].endswith("_Widget")
    assert node["size"] == MISSING
    assert node["name"] == "w"
    assert node["scale"] == 1.0


def test_builds_partial():
    fn = instantiate(builds(_Widget, zen_partial=True, size=3))
    obj = fn(name="x")
    assert obj.size == 3 and obj.name == "x"


def test_instantiate_nested():
    out = instantiate({"outer": {"_target_": f"{__name__}._Widget", "size": 2, "name": "inner"}})
    assert isinstance(out["outer"], _Widget)
    assert out["outer"].size == 2


def test_instantiate_missing_raises():
    with pytest.raises(ConfigError, match="size"):
        instantiate(builds(_Widget))


def test_merge_semantics():
    out = merge({"a": {"b": 1, "c": 2}, "l": [1, 2]}, {"a": {"b": 9}, "l": [3]})
    assert out == {"a": {"b": 9, "c": 2}, "l": [3]}


def test_interpolation(monkeypatch):
    cfg = {"experiment_name": "exp1", "tags": ["${experiment_name}"],
           "dir": "out/${experiment_name}/x", "env_val": "${env:MMLEARN_TEST_VAR,fallback}"}
    monkeypatch.delenv("MMLEARN_TEST_VAR", raising=False)
    out = resolve_interpolations(cfg)
    assert out["tags"] == ["exp1"]
    assert out["dir"] == "out/exp1/x"
    assert out["env_val"] == "fallback"
    monkeypatch.setenv("MMLEARN_TEST_VAR", "set")
    assert resolve_interpolations(cfg)["env_val"] == "set"


def test_store_register_and_group_override():
    store(group="test_group", name="widget", size=4)(_Widget)
    assert store.has("test_group", "widget")
    cfg = compose({"widget": None}, overrides=["test_group@widget=widget"])
    assert cfg["widget"]["size"] == 4
    assert isinstance(instantiate(cfg["widget"]), _Widget)


def test_compose_overrides():
    cfg = compose({"a": {"b": 1}, "name": MISSING}, overrides=["a.b=5", "name=hello",
                                                               "+extra.k=2.5"])
    assert cfg["a"]["b"] == 5
    assert cfg["name"] == "hello"
    assert cfg["extra"]["k"] == 2.5


def test_compose_override_unknown_key_requires_plus():
    with pytest.raises(ConfigError, match=r"\+a\.typo"):
        compose({"a": {"b": 1}}, overrides=["a.typo=5"])
    assert compose({"a": {"b": None}}, overrides=["a.b=3"])["a"]["b"] == 3


def test_compose_override_through_none_placeholder():
    base = {"trainer": {"mesh_shape": None}}
    assert compose(base, overrides=["trainer.mesh_shape.data=1"])["trainer"]["mesh_shape"] == {
        "data": 1}
    assert compose(base, overrides=["trainer.mesh_shape.a.b=1"])["trainer"]["mesh_shape"][
        "a"]["b"] == 1
    with pytest.raises(ConfigError, match=r"\+trainer\.mesh_shap\b"):
        compose(base, overrides=["trainer.mesh_shap=4"])


def test_compose_delete():
    assert "b" not in compose({"a": {"b": 1, "c": 2}}, overrides=["~a.b"])["a"]


def test_compose_experiment_yaml(tmp_path):
    store(group="test_group2", name="widget2", size=7)(_Widget)
    exp_dir = tmp_path / "experiment"
    exp_dir.mkdir()
    (exp_dir / "myexp.yaml").write_text(
        "defaults:\n  - /test_group2@model: widget2\nexperiment_name: myexp\n"
        "model:\n  name: override\n")
    cfg = compose({"experiment_name": MISSING, "model": None}, overrides=["+experiment=myexp"],
                  searchpath=[str(tmp_path)])
    assert cfg["experiment_name"] == "myexp"
    assert cfg["model"]["size"] == 7
    assert cfg["model"]["name"] == "override"


def test_base_config_builds():
    """The JAX schema on the port's ``Trainer`` (on the card by default) and
    ``DataLoader``; the port's export format by default."""
    from mmlearn_tpu_torch.conf import base_config

    cfg = base_config()
    assert cfg["task"] == MISSING
    assert cfg["trainer"]["device"] == "cuda"
    assert cfg["trainer"]["precision"] is None and cfg["trainer"]["mesh_shape"] is None
    assert "batch_size" in cfg["dataloader"]["train"] and "dataset" not in cfg["dataloader"]["train"]
    assert cfg["export"]["format"] == "artifact"
    cfg2 = compose(cfg, overrides=["experiment_name=t"])
    assert cfg2["tags"] == ["t"]
    assert cfg2["runtime"]["output_dir"] == "outputs/t"


def test_cli_override_wins_regardless_of_position():
    from mmlearn_tpu_torch.cli.run import build_experiment

    before = build_experiment(["trainer.max_steps=999", "+experiment=tiny_clip_synthetic"])
    after = build_experiment(["+experiment=tiny_clip_synthetic", "trainer.max_steps=999"])
    assert before["trainer"]["max_steps"] == after["trainer"]["max_steps"] == 999


def test_container_interpolation_resolves_and_copies():
    out = resolve_interpolations({"b": {"x": "${c}"}, "c": 5, "a": "${b}"})
    assert out["a"] == {"x": 5}
    out["a"]["x"] = 99
    assert out["b"]["x"] == 5


def test_nested_missing_value_rejected():
    with pytest.raises(ConfigError, match="Missing required value"):
        instantiate({"_target_": "builtins.dict", "cfg": {"lr": "???"}})
    out = instantiate({"_target_": "builtins.dict",
                       "sub": {"_target_": "builtins.dict", "a": 1}})
    assert out == {"sub": {"a": 1}}


def test_run_experiment_rejects_unset_required_values():
    from mmlearn_tpu_torch.cli.run import run_experiment

    cfg = {"task": {"_target_": "builtins.dict"}, "experiment_name": "???",
           "trainer": {}, "datasets": {}, "dataloader": {}, "runtime": {}}
    with pytest.raises(ConfigError, match="experiment_name"):
        run_experiment(cfg)


def test_sweep_split_honors_quotes_and_brackets():
    from mmlearn_tpu_torch.cli.run import _split_sweep_values

    assert _split_sweep_values("'a,b'") == ["'a,b'"]
    assert _split_sweep_values("1,2,3") == ["1", "2", "3"]
    assert _split_sweep_values("[1,2],[3,4]") == ["[1,2]", "[3,4]"]


def test_locate_reports_real_import_failures(tmp_path, monkeypatch):
    import sys

    from mmlearn_tpu_torch.conf.instantiate import locate

    (tmp_path / "broken_mod_xyz_torch.py").write_text(
        "import definitely_not_installed_pkg_qq\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop("broken_mod_xyz_torch", None)
    with pytest.raises(ConfigError, match="failed to import"):
        locate("broken_mod_xyz_torch.Thing")


# ------------------------------------------------ the port's registrations


def test_torch_optimizers_under_the_optax_names():
    """Each optax name of the JAX list that torch has builds that
    ``torch.optim`` class (also under its own name); the others raise a
    ``ConfigError`` naming them, with no stand-in."""
    import torch

    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.conf import OPTIMIZERS

    build_experiment(["experiment_name=t"])  # registers everything
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name, torch_name in OPTIMIZERS.items():
        node = store.get("modules/optimizers", name)
        if torch_name is not None and hasattr(torch.optim, torch_name):
            opt = instantiate(node)(params)
            assert type(opt) is getattr(torch.optim, torch_name), name
            assert store.get("modules/optimizers", torch_name) == node
        else:
            with pytest.raises(ConfigError, match=f"'{name}'"):
                instantiate(node)(params)
    assert store.has("modules/lr_schedulers", "linear_warmup_cosine_annealing_lr")


def test_registrations_mirror_the_jax_store():
    """Every group and name the JAX package registers, its projects'
    included, is in the port's store under the same group and name; only
    the optax schedules are left out (the port registers its own)."""
    from mmlearn_tpu.cli.run import build_experiment as jax_build
    from mmlearn_tpu.conf import store as jax_store
    from mmlearn_tpu_torch.cli.run import build_experiment

    jax_build(["experiment_name=t"])
    build_experiment(["experiment_name=t"])
    import mmlearn_tpu_torch.projects.bioscan_clip.configs  # noqa: F401
    import mmlearn_tpu_torch.projects.ijepa.configs  # noqa: F401
    import mmlearn_tpu_torch.projects.med_benchmarking.configs  # noqa: F401
    import mmlearn_tpu_torch.projects.multi_task.configs  # noqa: F401
    import projects.bioscan_clip.configs  # noqa: F401
    import projects.ijepa.configs  # noqa: F401
    import projects.med_benchmarking.configs  # noqa: F401
    import projects.multi_task.configs  # noqa: F401

    left_out: set = set()
    missing = []
    for group in jax_store.groups():
        if group.startswith("test_group") or group == "modules/optimizers":
            continue
        for name in jax_store.names(group):
            if jax_store.get(group, name)["_target_"].startswith("optax."):
                continue  # the optax schedules: the port registers its own
            if (group, name) not in left_out and not store.has(group, name):
                missing.append((group, name))
    assert not missing


def test_trainer_precision_and_mesh_shape():
    """``precision`` casts inputs as the JAX trainer's (fp16 names to
    bf16-mixed); a mesh over more devices than the processes raises; the
    model axis is accepted and meets the same check."""
    import torch

    from mmlearn_tpu_torch.tasks.base import TrainingTask
    from mmlearn_tpu_torch.trainer import Trainer

    task = TrainingTask()
    for precision, want in ((None, torch.float32), ("bf16", torch.bfloat16),
                            ("16-mixed", torch.bfloat16), ("32", torch.float32)):
        assert Trainer(precision=precision, device="cpu")._input_dtype(task) == want
    assert Trainer(precision="fp16", device="cpu").precision == "bf16-mixed"
    Trainer(mesh_shape={"data": 1}, device="cpu")
    with pytest.raises(ValueError, match="needs more than the 1 available"):
        Trainer(mesh_shape={"data": 4}, device="cpu")
    with pytest.raises(ValueError, match="needs more than the 1 available"):
        Trainer(mesh_shape={"data": 1, "model": 2}, device="cpu")


# ------------------------------------- the port's YAMLs against the JAX ones

_JAX_ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = {
    "tiny_clip_synthetic": (None, None),
    "tiny_ijepa_synthetic": (None, None),
    "contrastive_ijepa": ("pkg://projects.multi_task.configs",
                          "pkg://mmlearn_tpu_torch.projects.multi_task.configs"),
    "in1k_vit_small": ("pkg://projects.ijepa.configs",
                       "pkg://mmlearn_tpu_torch.projects.ijepa.configs"),
    "baseline": ("pkg://projects.med_benchmarking.configs",
                 "pkg://mmlearn_tpu_torch.projects.med_benchmarking.configs"),
    "zeroshot_classification_eval": ("pkg://projects.med_benchmarking.configs",
                                     "pkg://mmlearn_tpu_torch.projects.med_benchmarking.configs"),
    "bioscan_1m": ("pkg://projects.bioscan_clip.configs",
                   "pkg://mmlearn_tpu_torch.projects.bioscan_clip.configs"),
}


def to_port(node):
    """A JAX config node with the port's target names; an ``MLP`` head
    states the width flax infers from its input (its tower's)."""
    if isinstance(node, list):
        return [to_port(v) for v in node]
    if not isinstance(node, dict):
        return node
    if isinstance(node.get("heads"), dict) and isinstance(node.get("encoders"), dict):
        node = dict(node, heads={
            m: (dict(head, in_dim=node["encoders"][m].get("proj_dim")
                     or node["encoders"][m]["embed_dim"])
                if head.get("_target_", "").endswith("layers.mlp.MLP") and "in_dim" not in head
                else head)
            for m, head in node["heads"].items()})
    out = {}
    optax = node.get("_target_") == "optax.adamw"
    for key, value in node.items():
        if key == "scan_blocks":
            continue
        if key == "_target_":
            value = ("torch.optim.AdamW" if value == "optax.adamw" else
                     value.replace("mmlearn_tpu.", "mmlearn_tpu_torch.", 1)
                     if value.startswith("mmlearn_tpu.") else
                     "mmlearn_tpu_torch." + value if value.startswith("projects.") else value)
        if optax and key == "learning_rate":
            key = "lr"
        out[key] = to_port(value)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) and tree and "_target_" not in tree:
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_port_yaml_composes_to_the_jax_composition(name):
    """``experiment_name``, ``seed``, ``task``, ``datasets`` and ``job_type`` whole, and
    every ``dataloader`` and ``trainer`` value the YAML sets, equal the JAX
    composition's once mapped; the YAML sets nothing else."""
    from mmlearn_tpu.cli.run import build_experiment as jax_build
    from mmlearn_tpu_torch.cli.run import build_experiment

    jax_sp, port_sp = YAMLS[name]
    want = jax_build(([f"searchpath=[{jax_sp}]"] if jax_sp else []) + [f"+experiment={name}"])
    got = build_experiment(([f"searchpath=[{port_sp}]"] if port_sp else [])
                           + [f"+experiment={name}"])
    want = to_port(want)
    for key in ("experiment_name", "seed", "task", "datasets", "job_type"):
        assert got[key] == want[key], key
    body = yaml.safe_load(open(_port_yaml(name)))
    assert set(body) <= {"experiment_name", "seed", "task", "datasets", "dataloader", "trainer",
                         "job_type"}
    for section in ("dataloader", "trainer"):
        for path, value in _leaves(body.get(section, {})):
            g, w = got[section], want[section]
            for part in path.split("."):
                g, w = g[part], w[part]
            assert g == w, f"{section}.{path}"


def _port_yaml(name):
    import mmlearn_tpu_torch

    root = os.path.dirname(mmlearn_tpu_torch.__file__)
    for sub in ("conf/configs", "projects/multi_task/configs", "projects/ijepa/configs",
                "projects/med_benchmarking/configs", "projects/bioscan_clip/configs"):
        path = os.path.join(root, sub, "experiment", f"{name}.yaml")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(name)


def test_no_port_yaml_names_a_jax_target():
    """No ``_target_`` of a port YAML is in the JAX package, the root
    ``projects`` or optax."""
    import glob

    import mmlearn_tpu_torch

    root = os.path.dirname(mmlearn_tpu_torch.__file__)
    paths = glob.glob(os.path.join(root, "**", "*.yaml"), recursive=True)
    assert len(paths) == len(YAMLS)
    for path in paths:
        for line in open(path):
            if "_target_:" in line:
                target = line.split("_target_:", 1)[1].strip()
                assert not target.startswith(("mmlearn_tpu.", "projects.", "optax")), (
                    path, target)
