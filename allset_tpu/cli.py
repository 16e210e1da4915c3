"""Command-line experiment driver.

The ``python train.py --flags`` equivalent (reference
``src/train.py:220-528``), flag-compatible where sensible so reference
users can switch directly:

    python -m allset_tpu.cli --dname cora --method AllSetTransformer \
        --All_num_layers 1 --MLP_hidden 256 --Classifier_hidden 128 --heads 4

Results append to ``hyperparameter_tunning/{dname}_noise_{noise}.csv`` in
the reference's CSV format (``src/train.py:503-525``).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def _boolarg(s: str) -> bool:
    """argparse type=bool is a trap (bool("False") is True); accept the
    usual spellings. The reference can't disable these flags at all
    (store_true with set_defaults(True), train.py:264,285)."""
    return str(s).lower() in ("1", "true", "yes", "y", "t")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="allset_tpu experiment driver")
    p.add_argument("--train_prop", type=float, default=0.5)
    p.add_argument("--valid_prop", type=float, default=0.25)
    p.add_argument("--dname", default="walmart-trips-100")
    p.add_argument("--method", default="AllSetTransformer")
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--runs", default=20, type=int)
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--wd", default=0.0, type=float)
    p.add_argument("--All_num_layers", default=2, type=int)
    p.add_argument("--MLP_num_layers", default=2, type=int)
    p.add_argument("--MLP_hidden", default=64, type=int)
    p.add_argument("--Classifier_num_layers", default=2, type=int)
    p.add_argument("--Classifier_hidden", default=64, type=int)
    p.add_argument("--aggregate", default="mean", choices=["sum", "mean", "add"])
    p.add_argument("--normtype", default="all_one", choices=["all_one", "deg_half_sym"])
    p.add_argument("--add_self_loop", action="store_false")
    p.add_argument("--normalization", default="ln", choices=["bn", "ln", "None"])
    p.add_argument("--deepset_input_norm", default=True, type=_boolarg)
    p.add_argument("--GPR", action="store_true")
    p.add_argument("--LearnMask", action="store_true")
    p.add_argument("--feature_noise", default="1", type=str)
    p.add_argument("--exclude_self", action="store_true")
    p.add_argument("--heads", default=1, type=int)
    p.add_argument("--output_heads", default=1, type=int)
    p.add_argument("--HyperGCN_mediators", default=True, type=_boolarg)
    p.add_argument("--HyperGCN_fast", default=True, type=_boolarg)
    p.add_argument("--HNHN_alpha", default=-1.5, type=float)
    p.add_argument("--HNHN_beta", default=-0.5, type=float)
    p.add_argument("--HNHN_nonlinear_inbetween", default=True, type=_boolarg)
    p.add_argument("--HCHA_symdegnorm", action="store_true")
    p.add_argument("--UniGNN_use_norm", action="store_true")
    p.add_argument("--UniGNN_model_name", default="UniGCN")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--data_root", default="data/AllSet_all_raw_data")
    p.add_argument("--cache_dir", default="data/cache")
    p.add_argument("--res_root", default="hyperparameter_tunning")
    p.add_argument("--display_step", type=int, default=-1)
    p.add_argument("--no_vmap_runs", action="store_true",
                   help="run statistical replicas sequentially (low-memory)")
    p.add_argument("--vmap_chunk", type=int, default=None,
                   help="vmapped runs per device pass (default sized from "
                        "the device's memory; halves automatically when "
                        "the device runs out of memory)")
    p.add_argument("--epoch_chunk", type=int, default=None,
                   help="epochs per device call (default: the whole run "
                        "in one call)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize forward activations in the backward "
                        "(jax.checkpoint): bigger graphs per device")
    p.add_argument("--preset", action="store_true",
                   help="apply the tuned per-dataset AllSetTransformer preset")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed precision on the compute path")
    p.add_argument("--plot", default=None, metavar="PATH",
                   help="save train/valid/test accuracy curves (the "
                        "reference Logger.plot_result, src/train.py:152-167)")
    p.add_argument("--save_params", default=None, metavar="PATH",
                   help="save final-epoch parameters (np.savez archive; "
                        "vmapped runs carry a leading runs axis, "
                        "--no_vmap_runs saves the LAST run only)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run "
                        "(TensorBoard/Perfetto; benchmarks/trace_step.py "
                        "reads one in-process)")
    return p


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """Parse ``argv``, train, write the result CSVs; returns the
    trainer's ``Results`` (per-run, per-epoch metrics)."""
    args = build_parser().parse_args(argv)

    from allset_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from allset_tpu.data.registry import SYNTHETIC_FEATURE_DATASETS, load_dataset
    from allset_tpu.train import TrainConfig, Trainer
    from allset_tpu.train.factory import ExperimentConfig, prepare
    from allset_tpu.train.presets import preset_for

    noise = float(args.feature_noise)
    needs_noise = args.dname in SYNTHETIC_FEATURE_DATASETS

    overrides = {}
    if args.preset:
        overrides = preset_for(args.dname, noise if needs_noise else None)

    data = load_dataset(
        args.dname,
        root=args.data_root,
        cache_dir=args.cache_dir,
        feature_noise=noise if needs_noise or args.dname.startswith("synthetic") else None,
        seed=args.seed,
    )

    cfg = ExperimentConfig(
        method=args.method,
        dname=args.dname,
        epochs=overrides.get("epochs", args.epochs),
        runs=overrides.get("runs", args.runs),
        lr=overrides.get("lr", args.lr),
        wd=overrides.get("wd", args.wd),
        train_prop=args.train_prop,
        valid_prop=args.valid_prop,
        all_num_layers=overrides.get("all_num_layers", args.All_num_layers),
        mlp_num_layers=overrides.get("mlp_num_layers", args.MLP_num_layers),
        mlp_hidden=overrides.get("mlp_hidden", args.MLP_hidden),
        classifier_num_layers=overrides.get(
            "classifier_num_layers", args.Classifier_num_layers
        ),
        classifier_hidden=overrides.get("classifier_hidden", args.Classifier_hidden),
        heads=overrides.get("heads", args.heads),
        output_heads=args.output_heads,
        dropout=args.dropout,
        aggregate={"sum": "add"}.get(args.aggregate, args.aggregate),
        normtype=args.normtype,
        add_self_loop=args.add_self_loop,
        normalization=args.normalization,
        deepset_input_norm=args.deepset_input_norm,
        gpr=args.GPR,
        learn_mask=args.LearnMask,
        exclude_self=args.exclude_self,
        feature_noise=noise,
        hypergcn_mediators=args.HyperGCN_mediators,
        hypergcn_fast=args.HyperGCN_fast,
        hnhn_alpha=args.HNHN_alpha,
        hnhn_beta=args.HNHN_beta,
        hnhn_nonlinear_inbetween=args.HNHN_nonlinear_inbetween,
        hcha_symdegnorm=args.HCHA_symdegnorm,
        unignn_model_name=args.UniGNN_model_name,
        unignn_use_norm=args.UniGNN_use_norm,
        seed=args.seed,
        dtype=args.dtype,
    )

    model, batch, tx = prepare(cfg, data)
    trainer = Trainer(
        model,
        batch,
        TrainConfig(
            epochs=cfg.epochs, runs=cfg.runs, lr=cfg.lr, wd=cfg.wd,
            train_prop=cfg.train_prop, valid_prop=cfg.valid_prop,
            vmap_runs=not args.no_vmap_runs, seed=cfg.seed,
            vmap_chunk=args.vmap_chunk, epoch_chunk=args.epoch_chunk,
            remat=args.remat, display_step=args.display_step,
        ),
        tx=tx,
    )
    if args.profile:
        from allset_tpu.utils.profiling import trace

        with trace(args.profile):
            res = trainer.fit()
        print(f"Saved profiler trace to {args.profile}")
    else:
        res = trainer.fit()
    print(res.summary())
    if args.plot:
        print(f"Saved accuracy curves to {res.plot(args.plot)}")
    if args.save_params and res.params is not None:
        from allset_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save_params, res.params)
        print(f"Saved parameters to {args.save_params}")

    # CSV append in the reference's format (src/train.py:503-525)
    os.makedirs(args.res_root, exist_ok=True)
    filename = osp.join(args.res_root, f"{args.dname}_noise_{args.feature_noise}.csv")
    s = res.best_by_valid()
    vm, vs = s["highest_valid"]
    tm, ts = s["final_test"]
    avg_time = res.wall_time / max(cfg.runs, 1)
    with open(filename, "a+") as f:
        f.write(
            f"{cfg.method}_{cfg.lr}_{cfg.wd}_{cfg.heads}"
            f",{vm / 100:.3f} ± {vs / 100:.3f}"
            f",{tm / 100:.3f} ± {ts / 100:.3f}"
            f",{res.num_params}, {avg_time:.2f}s, 0.00s"
            f",{avg_time // 60}min{avg_time % 60:.2f}s\n"
        )
    all_args_file = osp.join(
        args.res_root, f"all_args_{args.dname}_noise_{args.feature_noise}.csv"
    )
    with open(all_args_file, "a+") as f:
        f.write(str(vars(args)) + "\n")
    print(f"Saved results to {filename}")
    return res


if __name__ == "__main__":
    raise SystemExit(main())
