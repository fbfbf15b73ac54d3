"""Quality gate of the port: CP2 pretrain → finetune → test Dice, end to end.

Twin of ``tools/quality_gate.py`` with the same flags and the same keys in
``quality_gate.json``: it runs the port's CLIs (``cp2_tpu_torch.train.
pretrain`` and ``finetune``) on the deterministic synthetic segmentation
corpus (``cp2_tpu_torch/tools/synthetic_corpus.py``) and reports

* test Dice / IoU of a finetune initialised from the CP2-pretrained
  checkpoint,
* test Dice / IoU of the identical finetune from scratch
  (``--pretrain_type NONE``), the control that shows whether the
  pretraining transfers.

It runs on the card; ``--device cpu`` runs it on the CPU (a smoke run at a
tiny size).  Paths default to directories of the repository
(``work_dirs/`` for the corpus and the runs, ``reports/quality_torch/`` for
the JSON).  Beside each JSON, ``<out>/card/<same name>`` records what the
run cost where it ran: the card's name and power limit, and for each CLI
call its seconds, steps, images/s, peak device memory, the memory still
held when it began, and the dense-loss kernels' launches.

Example: ``python -m cp2_tpu_torch.tools.quality_gate --pretrain_epochs 60
--finetune_epochs 40``
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_args(argv=None):
    p = argparse.ArgumentParser(description="CP2 pretrain, finetune and test Dice of the port")
    p.add_argument("--root", default=os.path.join(REPO, "work_dirs", "syn_corpus"))
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--n_val", type=int, default=60)
    p.add_argument("--n_test", type=int, default=80)
    p.add_argument("--n_unlabeled", type=int, default=0,
                   help="extra pretrain-only unlabeled images (0 = pretrain on the "
                        "labeled train images only)")
    p.add_argument("--img_size", type=int, default=160)
    p.add_argument("--pretrain_epochs", type=int, default=60)
    p.add_argument("--pretrain_batch", type=int, default=32)
    p.add_argument("--finetune_epochs", type=int, default=40)
    p.add_argument("--finetune_batch", type=int, default=16)
    p.add_argument("--train_ratio", type=float, default=1.0,
                   help="finetune label fraction (the reference sweeps 0.3/0.6/1.0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain_seed", type=int, default=None,
                   help="seed of the pretrain checkpoint to train/reuse; defaults to "
                        "--seed, so finetune-seed replicates can share one checkpoint")
    p.add_argument("--device", default=None,
                   help="'cpu' runs on the CPU (smoke); default: the card")
    p.add_argument("--log_dir", default=os.path.join(REPO, "work_dirs", "quality_gate"))
    p.add_argument("--skip_scratch", action="store_true")
    p.add_argument("--scratch_only", action="store_true",
                   help="run the scratch leg alone: no pretrain and no CP2 leg (the "
                        "scratch control's spread over finetune seeds)")
    p.add_argument("--finetune_float32", action="store_true",
                   help="finetune in float32 (--no-bf16); the gate's rows finetune in "
                        "bfloat16, the CLI's default")
    p.add_argument("--scratch_from", default="",
                   help="a prior quality_gate JSON whose finetune_scratch is reused (the "
                        "scratch control does not depend on the pretraining)")
    p.add_argument("--reuse_pretrain", action="store_true",
                   help="skip pretraining if a finished checkpoint exists under "
                        "<log_dir>/qg_pretrain_<seed>")
    p.add_argument("--out", default=os.path.join(REPO, "reports", "quality_torch"))
    p.add_argument("--corpus_version", type=int, default=1, choices=(1, 2, 3, 4),
                   help="synthetic-corpus version (2 = hard corpus); also tags the "
                        "output JSON")
    p.add_argument("--dryrun", action="store_true",
                   help="build and validate every CLI argv through the CLIs' get_args; "
                        "generate nothing, run nothing")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import torch

    from cp2_tpu_torch.checkpoint import latest_checkpoint
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.parallel import resolve_device
    from cp2_tpu_torch.tools.synthetic_corpus import generate, generate_unlabeled
    from cp2_tpu_torch.train import finetune, pretrain
    from cp2_tpu_torch.utils.benchmarking import card_line, peak_mib, reset_peak

    device = args.device or "cuda"
    img_dir = os.path.join(args.root, "images")
    if not args.dryrun and (not os.path.isdir(img_dir) or not os.listdir(img_dir)):
        print(f"generating corpus at {args.root} ...")
        generate(args.root, args.size,
                 {"train": args.n_train, "val": args.n_val, "test": args.n_test},
                 args.seed, version=args.corpus_version)

    pretrain_dirs = [img_dir]
    if args.n_unlabeled:
        un_dir = os.path.join(args.root, "unlabeled")
        have = len(os.listdir(un_dir)) if os.path.isdir(un_dir) else 0
        if have < args.n_unlabeled and not args.dryrun:
            print(f"generating {args.n_unlabeled} unlabeled pretrain images at {un_dir} ...")
            generate_unlabeled(args.root, args.size, args.n_unlabeled, args.seed,
                               version=args.corpus_version)
        pretrain_dirs.append(un_dir)

    results = {"config": vars(args).copy()}
    pretrain_seed = args.seed if args.pretrain_seed is None else args.pretrain_seed
    # ratio-tagged finetune run ids, so sweep legs do not share checkpoint
    # directories (the pretrain leg does not depend on the ratio)
    run_tag = f"s{pretrain_seed}"
    ft_tag = f"s{args.seed}"
    if args.n_unlabeled:
        run_tag = f"u{args.n_unlabeled}_{run_tag}"
        ft_tag = f"u{args.n_unlabeled}_{ft_tag}"
    if args.train_ratio != 1.0:
        ft_tag = f"r{args.train_ratio}_{ft_tag}"

    # ---- 1. CP2 pretrain on the train images ----
    pre_dir = os.path.join(args.log_dir, f"qg_pretrain_{run_tag}")

    def finished_ckpt():
        """The last checkpoint, if its meta says the whole epoch budget ran
        (a periodic save mid-run must lead to a resume, not a reuse)."""
        if not os.path.isdir(pre_dir):
            return None
        ckpts = sorted((d for d in os.listdir(pre_dir)
                        if d.isdigit() and os.path.isdir(os.path.join(pre_dir, d))), key=int)
        if not ckpts:
            return None
        last = os.path.join(pre_dir, ckpts[-1])
        meta_path = os.path.join(last, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                if json.load(fh).get("epoch", -1) >= args.pretrain_epochs:
                    return last
        return None

    t0 = time.time()
    pre_args = pretrain.get_args([
        "--run_id", f"qg_pretrain_{run_tag}", "--log_dir", args.log_dir,
        "--data_dirs", *pretrain_dirs, "--directory_type", "FILENAME",
        "--pretrain_type", "CP2",
        "--img_height", str(args.img_size), "--img_width", str(args.img_size),
        "--batch-size", str(args.pretrain_batch), "--epochs", str(args.pretrain_epochs),
        "--pretrain_from_scratch", "--cap_queue", "--seed", str(pretrain_seed),
        "--scalar-freq", "10",
        # periodic saves and a resume from the latest make the gate
        # idempotent: the same command run again continues
        "--ckpt-freq", "8", "--resume", pre_dir,
    ])
    mask_dir = os.path.join(args.root, "masks")

    def ft_argv(tag, pretrain_type, pretrain_path=""):
        ft = ["--run_id", f"qg_ft_{tag}_{ft_tag}", "--log_dir", args.log_dir,
              "--img_dirs", img_dir, "--mask_dirs", mask_dir,
              "--data_split_type", "FILENAME", "--train_data_ratio", str(args.train_ratio),
              "--img_height", str(args.img_size), "--img_width", str(args.img_size),
              "--batch_size", str(args.finetune_batch), "--epochs", str(args.finetune_epochs),
              "--pretrain_type", pretrain_type, "--seed", str(args.seed),
              "--visualize_freq", "0"]
        if args.finetune_float32:
            ft.append("--no-bf16")
        if pretrain_path:
            ft += ["--pretrain_path", pretrain_path]
        return ft

    if args.dryrun:
        for leg in (ft_argv("cp2", "CP2", "/dev/null/ckpt"), ft_argv("scratch", "NONE")):
            finetune.get_args(leg)
            print("[quality_gate dryrun] finetune:", " ".join(leg))
        print("[quality_gate dryrun] pretrain argv + 2 finetune argvs OK")
        return {"dryrun": True, "pre_args": pre_args}

    dev = resolve_device(device)
    card = {"card": card_line(dev), "legs": {}}

    def measured(leg, run, batch):
        """``run()`` → (result, steps run); its cost goes into ``card``."""
        reset_peak(dev)
        held = torch.cuda.memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
        dense_loss.reset_launch_counts()
        t = time.time()
        out, steps = run()
        sec = time.time() - t
        card["legs"][leg] = {"seconds": sec, "steps": steps, "batch": batch,
                             "images_per_s": steps * batch / sec, "peak_mib": peak_mib(dev),
                             "held_mib_at_start": held, "launches": dict(dense_loss.LAUNCHES)}
        return out

    def run_finetune(tag, pretrain_type, pretrain_path=""):
        ft_args = finetune.get_args(ft_argv(tag, pretrain_type, pretrain_path))

        def run():
            metrics = finetune.main(ft_args, device=device)
            return metrics, last_train_step(os.path.join(ft_args.log_dir, ft_args.run_id))

        metrics = measured(f"finetune_{tag}", run, args.finetune_batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["seconds"] = card["legs"][f"finetune_{tag}"]["seconds"]
        return metrics

    def run_pretrain():
        resumed = latest_checkpoint(pre_dir)  # where --resume starts
        begun = int(os.path.basename(resumed)) if resumed else 0
        state = pretrain.main(pre_args, device=device)
        return None, int(state.step) - begun  # the state is dropped here

    if args.scratch_only:
        results.update(pretrain_seconds=None, pretrain_ckpt=None,
                       pretrain_loss_first=None, pretrain_loss_last=None)
        print("[quality_gate] finetuning from scratch alone ...")
        results["finetune_scratch"] = run_finetune("scratch", "NONE")
        return write_results(args, results, card)
    if args.reuse_pretrain and finished_ckpt():
        print(f"[quality_gate] reusing pretrain checkpoint under {pre_dir}")
        results["pretrain_seconds"] = None
    else:
        print(f"[quality_gate] pretraining CP2 for {args.pretrain_epochs} epochs ...")
        measured("pretrain", run_pretrain, args.pretrain_batch)
        results["pretrain_seconds"] = time.time() - t0
    pretrain_path = finished_ckpt()
    if pretrain_path is None:
        raise RuntimeError(f"no finished ({args.pretrain_epochs}-epoch) pretrain "
                           f"checkpoint under {pre_dir}")
    results["pretrain_ckpt"] = pretrain_path

    losses = []
    with open(os.path.join(pre_dir, "metrics.jsonl")) as fh:
        for line in fh:
            row = json.loads(line)
            if "train/loss_step" in row:
                losses.append(row["train/loss_step"])
    results["pretrain_loss_first"] = losses[0] if losses else None
    results["pretrain_loss_last"] = losses[-1] if losses else None

    # ---- 2. finetune from the CP2 checkpoint ----
    print("[quality_gate] finetuning from the CP2 checkpoint ...")
    results["finetune_cp2"] = run_finetune("cp2", "CP2", pretrain_path)

    # ---- 3. control: the identical finetune from scratch ----
    if args.scratch_from:
        with open(args.scratch_from) as fh:
            prior = json.load(fh)
        if prior["config"]["train_ratio"] != args.train_ratio:
            raise ValueError("--scratch_from was run at another --train_ratio")
        results["finetune_scratch"] = dict(prior["finetune_scratch"],
                                           imported_from=args.scratch_from)
    elif not args.skip_scratch:
        print("[quality_gate] finetuning from scratch (control) ...")
        results["finetune_scratch"] = run_finetune("scratch", "NONE")
    if "finetune_scratch" in results:
        results["dice_gain_over_scratch"] = (
            results["finetune_cp2"].get("test_Dice", float("nan"))
            - results["finetune_scratch"].get("test_Dice", float("nan")))

    return write_results(args, results, card)


def write_results(args, results, card):
    """Write the row and its ``card/`` twin under ``--out``; returns the row."""
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "quality_gate.json")
    # one file per pool, ratio and seed, so sweeps do not overwrite each other
    if (args.train_ratio != 1.0 or args.seed != 0 or args.n_unlabeled
            or args.corpus_version != 1):
        pool = f"u{args.n_unlabeled}_" if args.n_unlabeled else ""
        ver = f"v{args.corpus_version}_" if args.corpus_version != 1 else ""
        out_path = os.path.join(
            args.out, f"quality_gate_{ver}{pool}r{args.train_ratio}_s{args.seed}.json")
    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=1)
    os.makedirs(os.path.join(args.out, "card"), exist_ok=True)
    with open(os.path.join(args.out, "card", os.path.basename(out_path)), "w") as fh:
        json.dump(card, fh, indent=1)
    print(json.dumps({k: v for k, v in results.items() if k != "config"}, indent=1))
    return results


def last_train_step(run_dir):
    """The step of the finetune's last epoch row in ``metrics.jsonl``: the
    train steps it ran (a finetune always starts at step 0)."""
    step = 0
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        for line in fh:
            row = json.loads(line)
            if "train_loss" in row:
                step = int(row["_step"])
    return step


if __name__ == "__main__":
    main()
