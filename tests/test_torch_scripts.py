"""The port's experiment drivers (``cp2_tpu_torch/scripts/*.sh``) against the
JAX package's (``scripts/*.sh``), on the CPU.

* Each of the 13 drivers, run under ``CP2_SCRIPT_DRYRUN=1``, prints the JAX
  driver's invocations with ``cp2_tpu/configs`` mapped to
  ``cp2_tpu_torch/configs`` (and ``config_moco.py`` given to the two
  same-foreground pretrains that cannot start without it); each parses
  through the port's ``get_args`` (and, for pretrain, the
  ``hparams_from_args`` that ``main`` calls).
* Every JAX driver, ``scripts/dist_train.sh`` and
  ``tools/run_v4_gate_sweep.sh`` has a twin of the same name, and no twin
  names the JAX package.
* The launcher (``launch.sh``) starts one process on one card and
  ``torchrun`` on more, and stops with an error on none: stub ``python``,
  ``python3`` and ``torchrun`` on ``PATH`` answer the card count and log
  what they were asked to run.  The same stubs check ``dist_train.sh`` and
  the gate sweep, whose rows parse through the port's
  ``quality_gate --dryrun``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shlex
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")
PORT_SCRIPTS = os.path.join(REPO, "cp2_tpu_torch", "scripts")
GATE_SWEEP = "run_v4_gate_sweep.sh"
# common.sh is the library the drivers source; dist_train.sh has its own
# positional protocol (tested below with the launcher)
DRIVERS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(JAX_SCRIPTS, "*.sh"))
                 if os.path.basename(p) not in ("common.sh", "dist_train.sh"))
KINDS = ("PRETRAIN", "FINETUNE", "MIRROR")
IMGNET_TYPES = [
    "DENSECL_IMGNET", "DINO_IMGNET", "BARLOWTWINS_IMGNET", "VICEREGL_IMGNET",
    "MOCO_IMGNET", "PIXPRO_IMGNET", "BYOL_IMGNET", "CP2_IMGNET",
    "MOSREP_IMGNET", "CLOVE_IMGNET",
]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    for d in ("data", "data2", "img", "mask", "logs"):
        (tmp / d).mkdir()
    ckpts = tmp / "ckpts"
    ckpts.mkdir()
    for t in IMGNET_TYPES:
        (ckpts / f"{t}.pth").touch()  # imgnet-pretrained.sh skips absent files
    out = {k: v for k, v in os.environ.items() if k != "CP2_SCRIPT_DRYRUN"}
    out.update(DATA_DIR=str(tmp / "data"), DATA_DIR2=str(tmp / "data2"),
               IMG_DIR=str(tmp / "img"), MASK_DIR=str(tmp / "mask"), CKPT_DIR=str(ckpts),
               LOG_DIR=str(tmp / "logs"))
    return out


def _run(script, env, *args, dryrun=True):
    proc = subprocess.run(["bash", script, *args], capture_output=True, text=True, timeout=60,
                          env=dict(env, **({"CP2_SCRIPT_DRYRUN": "1"} if dryrun else {})))
    return proc


def _invocations(stdout):
    out = []
    for line in stdout.splitlines():
        kind, _, argstr = line.partition("\t")
        if kind in KINDS:
            out.append((kind, shlex.split(argstr)))
    return out


PORT_CONFIGS = os.path.join(REPO, "cp2_tpu_torch", "configs") + os.sep
# same-foreground.sh's MoCo and BYOL pretrains, which the twin gives
# config_moco.py (their JAX invocations cannot start: see that twin)
NEEDS_MOCO_CONFIG = re.compile(r"^PRETRAIN\t.* --run_id same-fg-(MOCO|BYOL) ")


def _jax_to_port(text):
    """A JAX driver's dry-run output as its twin prints it."""
    text = text.replace(os.path.join(REPO, "cp2_tpu", "configs") + os.sep, PORT_CONFIGS)
    return "\n".join(line + f" --config {PORT_CONFIGS}config_moco.py"
                     if NEEDS_MOCO_CONFIG.match(line) else line for line in text.split("\n"))


@pytest.mark.parametrize("name", DRIVERS)
def test_twin_prints_the_jax_invocations_and_they_parse(name, env):
    from cp2_tpu_torch.train import finetune, mirror_pretrain, pretrain

    ours = _run(os.path.join(PORT_SCRIPTS, name), env)
    theirs = _run(os.path.join(JAX_SCRIPTS, name), env)
    assert ours.returncode == 0 and theirs.returncode == 0, (ours.stderr, theirs.stderr)
    assert ours.stdout == _jax_to_port(theirs.stdout)
    invocations = _invocations(ours.stdout)
    assert invocations, f"{name} printed no invocation under CP2_SCRIPT_DRYRUN=1"
    for kind, argv in invocations:
        if kind == "PRETRAIN":
            args = pretrain.get_args(argv)
            pretrain.hparams_from_args(args, dataset_size=1000)  # as main() validates
        elif kind == "FINETUNE":
            args = finetune.get_args(argv)
        else:
            args = mirror_pretrain.get_args(argv)
        cfg = getattr(args, "config", None)
        if cfg and cfg.startswith(REPO):
            assert cfg.startswith(os.path.join(REPO, "cp2_tpu_torch", "configs")), cfg
            assert os.path.exists(cfg), cfg


def test_same_foreground_moco_and_byol_need_config_moco(env):
    """The JAX driver's MoCo and BYOL same-foreground pretrains name no
    ``--config``: config_pretrain.py's 128-d contrast head beside a 256-d
    embedding, which ``SSLEncoder`` refuses before building anything; the
    twin's config_moco.py has no contrast head."""
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder
    from cp2_tpu_torch.train import pretrain

    theirs = _invocations(_run(os.path.join(JAX_SCRIPTS, "same-foreground.sh"), env).stdout)
    ours = _invocations(_run(os.path.join(PORT_SCRIPTS, "same-foreground.sh"), env).stdout)
    checked = 0
    assert [k for k, _ in theirs] == [k for k, _ in ours]
    for (kind, jax_argv), (_, port_argv) in zip(theirs, ours):
        if kind != "PRETRAIN":
            assert port_argv == jax_argv
            continue
        args = pretrain.get_args(jax_argv)
        if args.run_id not in ("same-fg-MOCO", "same-fg-BYOL"):
            assert port_argv == jax_argv
            continue
        hp = pretrain.hparams_from_args(args, dataset_size=1000)
        default = os.path.join(REPO, "cp2_tpu_torch", "configs", "config_pretrain.py")
        with pytest.raises(ValueError, match="contrast_dim=128 must equal"):
            SSLEncoder(dict(Config.fromfile(default).model), pretrain_type=args.pretrain_type,
                       dim=hp.dim, img_hw=(224, 224))
        fixed = pretrain.get_args(port_argv)
        assert port_argv[:len(jax_argv)] == jax_argv
        assert fixed.config == PORT_CONFIGS + "config_moco.py"
        assert not Config.fromfile(fixed.config).model.decode_head.get("contrast", False)
        checked += 1
    assert checked == 2


def test_every_jax_driver_has_a_twin_that_names_only_the_port():
    twins = {os.path.basename(p) for p in glob.glob(os.path.join(PORT_SCRIPTS, "*.sh"))}
    jax = {os.path.basename(p) for p in glob.glob(os.path.join(JAX_SCRIPTS, "*.sh"))}
    assert len(jax) == 15 and jax <= twins, jax - twins
    gate = os.path.join(REPO, "cp2_tpu_torch", "tools", GATE_SWEEP)
    assert os.path.exists(os.path.join(REPO, "tools", GATE_SWEEP)) and os.path.exists(gate)
    for path in [*glob.glob(os.path.join(PORT_SCRIPTS, "*.sh")), gate]:
        with open(path) as f:
            text = f.read()
        bad = re.findall(r"cp2_tpu(?!_torch)[./]\S*", text)
        assert not bad, f"{os.path.basename(path)} names the JAX package: {bad}"


def test_the_drivers_cover_every_entry_kind(env):
    kinds = set()
    for name in DRIVERS:
        kinds.update(k for k, _ in _invocations(_run(os.path.join(PORT_SCRIPTS, name),
                                                     env).stdout))
    assert kinds == set(KINDS)


STUB = """#!{python}
import json, os, sys
if sys.argv[1:2] == ["-c"]:
    print(os.environ["STUB_CARDS"])
    sys.exit(0)
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps({{"argv": [os.path.basename(sys.argv[0]), *sys.argv[1:]],
                         "pythonpath": os.environ.get("PYTHONPATH", ""),
                         "cwd": os.getcwd()}}) + "\\n")
"""


@pytest.fixture(scope="module")
def stub_path(tmp_path_factory):
    """A directory of stubs for ``python``, ``python3`` and ``torchrun``,
    first on ``PATH``."""
    bin_dir = tmp_path_factory.mktemp("stub_bin")
    for name in ("python", "python3", "torchrun"):
        stub = bin_dir / name
        stub.write_text(STUB.format(python=sys.executable))
        stub.chmod(stub.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return str(bin_dir)


def _stubbed(script, env, stub_path, tmp_path, cards, *args):
    log = tmp_path / f"calls_{cards}.jsonl"
    proc = _run(script, dict(env, PATH=stub_path + os.pathsep + env["PATH"],
                             STUB_CARDS=str(cards), STUB_LOG=str(log)), *args, dryrun=False)
    calls = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
    return proc, calls


@pytest.mark.parametrize("cards", [0, 1, 4, "unknown"])
def test_the_launcher_runs_one_process_a_card_and_never_the_cpu(cards, env, stub_path,
                                                                tmp_path):
    """``polyp-cutpaste.sh``: its preflight (``chip_smoke.py --preflight``),
    then the mirror CLI with the dry run's flags: ``python -m`` on one card,
    ``torchrun --standalone --nproc_per_node 4 -m`` on four, an error and
    no CLI on none or on a count that is not a number."""
    script = os.path.join(PORT_SCRIPTS, "polyp-cutpaste.sh")
    proc, calls = _stubbed(script, env, stub_path, tmp_path, cards)
    preflight = ["python3", os.path.join(REPO, "chip_smoke.py"), "--preflight"]
    assert calls[0]["argv"] == preflight
    if cards in (0, "unknown"):
        assert proc.returncode != 0 and len(calls) == 1
        assert ("no CUDA card" if cards == 0 else "cannot count the cards") in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr
    [(kind, flags)] = _invocations(_run(script, env).stdout)
    module = "cp2_tpu_torch.train.mirror_pretrain"
    want = (["python", "-m", module] if cards == 1 else
            ["torchrun", "--standalone", "--nproc_per_node", "4", "-m", module])
    assert kind == "MIRROR" and [c["argv"] for c in calls[1:]] == [want + flags]
    assert calls[1]["pythonpath"].split(os.pathsep)[0] == REPO


@pytest.mark.parametrize("cards", [1, 2])
def test_dist_train_runs_the_iteration_cli_through_the_launcher(cards, stub_path, tmp_path):
    from cp2_tpu_torch.train import iter_train

    config = os.path.join(REPO, "cp2_tpu_torch", "configs", "example_iter_train.py")
    _, calls = _stubbed(os.path.join(PORT_SCRIPTS, "dist_train.sh"), dict(os.environ),
                        stub_path, tmp_path, cards, config, "--work-dir", "w", "--seed", "3")
    prefix = (["python"] if cards == 1 else
              ["torchrun", "--standalone", "--nproc_per_node", str(cards)])
    rest = ["-m", "cp2_tpu_torch.train.iter_train", config, "--work-dir", "w", "--seed", "3"]
    assert [c["argv"] for c in calls] == [prefix + rest]
    args = iter_train.get_args(rest[2:])
    assert (args.config, args.work_dir, args.seed) == (config, "w", 3)


def test_gate_sweep_runs_the_jax_rows_through_the_ports_quality_gate(stub_path, tmp_path):
    """The same rows as ``tools/run_v4_gate_sweep.sh`` (the corpus path
    shared, since the port's corpus is bit-equal; the runs under a log
    directory of their own), each parsed by ``quality_gate --dryrun``."""
    from cp2_tpu_torch.tools import quality_gate

    def rows(script, sub):
        (tmp_path / sub).mkdir()
        _, calls = _stubbed(script, dict(os.environ), stub_path, tmp_path / sub, 1, "0.3", "1.0")
        return [c["argv"] for c in calls], calls

    ours, calls = rows(os.path.join(REPO, "cp2_tpu_torch", "tools", GATE_SWEEP), "port")
    theirs, _ = rows(os.path.join(REPO, "tools", GATE_SWEEP), "jax")
    assert len(ours) == len(theirs) == 4
    assert all(os.path.realpath(c["cwd"]) == os.path.realpath(REPO) for c in calls)
    for row, ref in zip(ours, theirs):
        assert row[:3] == ["python", "-m", "cp2_tpu_torch.tools.quality_gate"]
        assert ref[:2] == ["python", "tools/quality_gate.py"]
        flags, ref_flags = row[3:], ref[2:]
        i = flags.index("--log_dir") + 1
        assert flags[i] != ref_flags[i]  # the port's runs are kept apart
        assert flags[:i] + flags[i + 1:] == ref_flags[:i] + ref_flags[i + 1:]
        out = quality_gate.main([*flags, "--dryrun"])
        assert out["dryrun"] and out["pre_args"].pretrain_type.name == "CP2"
    assert [r[r.index("--seed") + 1] for r in ours] == ["0", "1", "0", "1"]


GATE_ROWS = os.path.join(REPO, "cp2_tpu_torch", "tools", "run_gate_rows.sh")


def _gate_calls(stub_path, tmp_path, mode, others=None):
    """``run_gate_rows.sh mode``'s gate calls, each parsed by the port's
    gate and checked by its ``--dryrun``.  Any other call is a failure,
    unless ``others`` (a list) is given: the other calls' argv go there."""
    from cp2_tpu_torch.tools import quality_gate

    proc, calls = _stubbed(GATE_ROWS, dict(os.environ), stub_path, tmp_path, 1, mode)
    assert proc.returncode == 0, proc.stderr
    out = []
    for call in calls:
        assert os.path.realpath(call["cwd"]) == os.path.realpath(REPO)
        if others is not None and call["argv"][:3] != [
                "python", "-m", "cp2_tpu_torch.tools.quality_gate"]:
            others.append(call["argv"])
            continue
        assert call["argv"][:3] == ["python", "-m", "cp2_tpu_torch.tools.quality_gate"]
        flags = call["argv"][3:]
        assert quality_gate.main([*flags, "--dryrun"])["dryrun"]
        out.append(quality_gate.get_args(flags))
    return out


def test_gate_rows_run_the_jax_u1600_rows_on_one_pretrain(stub_path, tmp_path):
    """``run_gate_rows.sh u1600``: one gate call per JAX v1 pool-1600 row
    with its training settings, seed, pretrain seed and reuse, the first
    training the pretrain the others reuse; a scratch leg imported where
    the JAX row imported it, from the port's row of the same name."""
    calls = _gate_calls(stub_path, tmp_path, "u1600")
    jax_rows = [json.load(open(p)) for p in sorted(glob.glob(os.path.join(
        REPO, "reports", "quality", "quality_gate_u1600_*.json")))]
    assert len(calls) == len(jax_rows) == 5
    assert not calls[0].reuse_pretrain and all(c.reuse_pretrain for c in calls[1:])
    assert len({(c.root, c.log_dir) for c in calls}) == 1
    for row in jax_rows:
        cfg = row["config"]
        (call,) = [c for c in calls
                   if (c.train_ratio, c.seed) == (cfg["train_ratio"], cfg["seed"])]
        for key in ("n_unlabeled", "pretrain_epochs", "pretrain_batch", "finetune_epochs",
                    "finetune_batch", "size", "img_size", "n_train", "n_val", "n_test",
                    "reuse_pretrain", "skip_scratch"):
            assert getattr(call, key) == cfg[key], key
        assert call.pretrain_seed == cfg.get("pretrain_seed") and call.corpus_version == 1
        if cfg["scratch_from"]:
            assert call.scratch_from == os.path.join(
                "reports", "quality_torch", os.path.basename(cfg["scratch_from"]))
        else:
            assert call.scratch_from == ""


def test_gate_rows_run_five_finetune_seeds_per_seed_group(stub_path, tmp_path):
    """``run_gate_rows.sh seed_spread``: five CP2-only finetune seeds on one
    pretrain per group, each corpus version under a --root and --log_dir of
    its own (the pretrain's run id does not name the corpus version)."""
    calls = _gate_calls(stub_path, tmp_path, "seed_spread")
    groups = {}
    for call in calls:
        groups.setdefault(call.out, []).append(call)
    want = {"v4_u1600_r0.1": (4, 1600, 0.1), "v1_r0.3": (1, 0, 0.3)}
    assert sorted(groups) == sorted(os.path.join("reports", "quality_torch", "seed_spread", g)
                                    for g in want)
    for out, group in groups.items():
        assert [c.seed for c in group] == [0, 1, 2, 3, 4]
        assert {(c.corpus_version, c.n_unlabeled, c.train_ratio) for c in group} == {
            want[os.path.basename(out)]}
        assert all(c.pretrain_seed == 0 and c.reuse_pretrain and c.skip_scratch
                   and c.pretrain_epochs == 60 for c in group)
        assert len({(c.root, c.log_dir) for c in group}) == 1
    assert len({(g[0].root) for g in groups.values()}) == 2
    assert len({(g[0].log_dir) for g in groups.values()}) == 2


def test_gate_rows_split_the_v1_r03_setting_into_two_groups(stub_path, tmp_path):
    """``run_gate_rows.sh v1_r0.3_groups``: the scratch leg alone at
    finetune seeds 0-4, then the CP2 leg at finetune seed 0 on pretrain
    seeds 0-4 (each trains its own pretrain, each row to a directory of its
    own), all on the v1 pool-400 corpus and log directory of the
    ``seed_spread`` group at ratio 0.3; then ``seed_group`` summarises each
    group (gathering the pretrain-seed rows into theirs) and the corpus is
    held to its committed digests."""
    others = []
    calls = _gate_calls(stub_path, tmp_path, "v1_r0.3_groups", others)
    (tmp_path / "spread").mkdir()
    spread = _gate_calls(stub_path, tmp_path / "spread", "seed_spread")
    v1 = [c for c in spread if c.out.endswith("v1_r0.3")][0]
    scratch, pseeds = calls[:5], calls[5:]
    assert len(pseeds) == 5
    for c in calls:
        assert (c.root, c.log_dir, c.train_ratio, c.corpus_version, c.n_unlabeled,
                c.pretrain_epochs, c.finetune_epochs) == (v1.root, v1.log_dir, 0.3, 1, 0, 60, 40)
    group = os.path.join("reports", "quality_torch", "seed_spread")
    assert [c.seed for c in scratch] == [0, 1, 2, 3, 4]
    assert all(c.scratch_only and c.out == os.path.join(group, "v1_r0.3_scratch")
               for c in scratch)
    assert [(c.seed, c.pretrain_seed) for c in pseeds] == [(0, p) for p in range(5)]
    assert all(c.reuse_pretrain and c.skip_scratch and not c.scratch_only for c in pseeds)
    assert len({c.out for c in pseeds}) == 5
    module = ["python", "-m", "cp2_tpu_torch.tools.seed_group"]
    summary, gathered, corpus = others
    assert summary == module + [os.path.join(group, "v1_r0.3_scratch"), "--out",
                                os.path.join(group, "v1_r0.3_scratch", "SUMMARY.md")]
    assert gathered[:3] == module and gathered[-4:] == [
        "--gather", os.path.join(group, "v1_r0.3_pretrain_seeds"), "--out",
        os.path.join(group, "v1_r0.3_pretrain_seeds", "SUMMARY.md")]
    assert corpus == ["python", "-m", "cp2_tpu_torch.tools.synthetic_corpus", "--out", v1.root,
                      "--check", os.path.join("reports", "quality_torch",
                                              "corpus_v1_s0_160.json")]


def test_gate_rows_run_the_scratch_group_in_float32(stub_path, tmp_path):
    """``run_gate_rows.sh v1_r0.3_scratch_fp32``: the scratch group's five
    calls again with ``--finetune_float32``, on the same corpus under a log
    directory of their own, into a group of their own."""
    others = []
    calls = _gate_calls(stub_path, tmp_path, "v1_r0.3_scratch_fp32", others)
    (tmp_path / "bf16").mkdir()
    bf16 = _gate_calls(stub_path, tmp_path / "bf16", "v1_r0.3_groups", [])[:5]
    group = os.path.join("reports", "quality_torch", "seed_spread", "v1_r0.3_scratch_fp32")
    assert [c.seed for c in calls] == [0, 1, 2, 3, 4]
    for c, ref in zip(calls, bf16):
        assert c.finetune_float32 and not ref.finetune_float32
        assert c.root == ref.root and c.log_dir != ref.log_dir and c.out == group
        assert vars(c) | {"finetune_float32": False, "log_dir": "", "out": ""} == \
            vars(ref) | {"log_dir": "", "out": ""}
    assert others == [["python", "-m", "cp2_tpu_torch.tools.seed_group", group, "--out",
                       os.path.join(group, "SUMMARY.md")]]
