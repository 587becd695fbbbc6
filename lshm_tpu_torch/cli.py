"""Command-line interface of the port (port of ``lshm_tpu/cli.py``): the JAX package's
subcommands, flags, defaults and printed lines over ``lshm_tpu_torch``.

    python -m lshm_tpu_torch.cli synth --out data/
    python -m lshm_tpu_torch.cli train --data-dir data/ --preset full_khm \\
           --set train.num_epochs=2 --set data.batch_size=8
    python -m lshm_tpu_torch.cli eval --data-dir data/ --ckpt checkpoints/ --out results/
    python -m lshm_tpu_torch.cli import-torch --net net.model --net-t netT.model \\
           --net-f netF.model --khm khm.model --out checkpoints/
    python -m lshm_tpu_torch.cli export --ckpt checkpoints/ --out lshm_forward.pt2
    python -m lshm_tpu_torch.cli rica --data-dir data/ --out rica_out/
    python -m lshm_tpu_torch.cli graph station --data-dir data/ --ckpt checkpoints/

Training, evaluation, export, RICA and the graph networks run on the card;
``LSHM_PLATFORM=cpu`` runs them on the CPU instead (any other value is an error).
``train`` runs data-parallel over several processes, one per card, under
``torchrun --nproc-per-node N -m lshm_tpu_torch.cli train ...`` or with
``--coordinator/--num-processes/--process-id`` in each process; rank 0 prints the
metrics and writes ``--log-jsonl``.  ``bench`` keeps JAX's flags and exits non-zero
naming the ROADMAP item that ports it.  Every import of torch and of the port's modules happens inside a command, so
``--help`` loads neither.
"""

from __future__ import annotations

import argparse
import os
import sys

PRESETS = ["ae2d_adam", "fourier_cascade", "full_khm", "full_khm_bf16", "full_khm_lbfgs"]


def _add_set(p):
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VAL",
        help="config override, e.g. data.batch_size=4 or optim.optimizer=lbfgs",
    )


def _device() -> str | None:
    """``LSHM_PLATFORM``: unset means the card (the entry points raise without one),
    ``cpu`` the CPU."""
    plat = os.environ.get("LSHM_PLATFORM")
    if plat is None:
        return None
    if plat.lower() == "cpu":
        return "cpu"
    sys.exit(f"error: LSHM_PLATFORM={plat!r}: lshm_tpu_torch runs on the card "
             "(LSHM_PLATFORM unset) or on the CPU (LSHM_PLATFORM=cpu)")


def _not_ported(what: str, item: str):
    def refuse(args):
        sys.exit(f"error: {what} is not ported to lshm_tpu_torch yet (ROADMAP {item})")

    return refuse


def cmd_synth(args):
    from lshm_tpu_torch.data.synthetic import write_synthetic_h5

    path = write_synthetic_h5(
        f"{args.out}/L000001.MS_extract.h5",
        nstations=args.nstations, ntime=args.ntime, nfreq=args.nfreq, seed=args.seed,
    )
    print(f"wrote {path}")


def _build_config(args):
    import dataclasses

    from lshm_tpu_torch.config import _apply_overrides, check_supported, preset

    cfg = preset(args.preset)
    if getattr(args, "data_dir", None):
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=args.data_dir))
    try:
        cfg = _apply_overrides(cfg, args.set)
    except (AssertionError, ValueError, AttributeError) as e:
        sys.exit(f"error: bad --set override: {e}")
    try:
        check_supported(cfg)
    except ValueError as e:
        sys.exit(f"error: {e}")
    return cfg


def _loaded_trainer(cfg, ckpt: str):
    from lshm_tpu_torch.train.trainer import Trainer

    t = Trainer(cfg, device=_device())
    try:
        t.load(ckpt)
    except FileNotFoundError as e:
        sys.exit(f"error: no checkpoint found at {ckpt!r} ({e})")
    return t


def cmd_train(args):
    from lshm_tpu_torch.train.distributed import init_distributed
    from lshm_tpu_torch.train.parallel import world_and_rank
    from lshm_tpu_torch.train.trainer import Trainer
    from lshm_tpu_torch.utils.metrics import MetricLogger

    device = _device()
    try:      # the flags, else torchrun's environment; a no-op for one process
        n = init_distributed(args.coordinator, args.num_processes, args.process_id)
    except ValueError as e:
        sys.exit(f"error: {e}")
    if n > 1 and not args.quiet:
        print(f"distributed: {n} process(es)")
    cfg = _build_config(args)
    # one rank logs: the metrics are the ranks' mean, the same on each
    lead = world_and_rank()[1] == 0
    logger = MetricLogger(jsonl_path=args.log_jsonl if lead else None,
                          echo=not args.quiet and lead)
    try:
        t = Trainer(cfg, device=device, logger=logger, profile_dir=args.profile_dir)
    except ValueError as e:       # train.mesh_shape against the world size
        sys.exit(f"error: {e}")
    if t.world_size > 1 and not args.quiet:
        print(f"data parallel: {{'{cfg.train.mesh_axes[0]}': {t.world_size}}} over "
              f"{t.world_size} rank(s); rank {t.rank} on {t.device}")
    if args.resume:
        t.load(cfg.train.checkpoint_dir)
    summary = t.run()
    print(f"done: {summary}")
    if n > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_eval(args):
    import numpy as np

    from lshm_tpu_torch.data import scan_files
    from lshm_tpu_torch.eval import evaluate_sap

    cfg = _build_config(args)
    t = _loaded_trainer(cfg, args.ckpt)
    files, saps = scan_files(cfg.data.data_dir, cfg.data.file_pattern)
    if not files:
        sys.exit(f"no valid H5 data under {cfg.data.data_dir!r}")
    idx = args.sap_index % len(files)
    res = evaluate_sap(
        t.model, files[idx], saps[idx],
        patch_size=cfg.data.patch_size, num_channels=cfg.data.num_channels,
        order=cfg.model.khm_order, num_hard_clusters=args.hard_clusters,
        out_dir=args.out, montages=args.montages, recon_panels=args.recon_panels,
        device=t.device,
    )
    print(f"evaluated {res.X.shape[1]} baselines; "
          f"soft cluster histogram: {np.bincount(res.soft_assign).tolist()}")


def cmd_import_torch(args):
    from lshm_tpu_torch.utils.checkpoint import save_checkpoint
    from lshm_tpu_torch.utils.torch_import import (
        load_reference_checkpoints,
        load_reference_checkpoints_fourier,
    )

    if args.fnet:
        if args.net_t or args.net_f:
            sys.exit("error: pass either --fnet (legacy Fourier trio) or "
                     "--net-t/--net-f (current pipeline), not both")
        params = load_reference_checkpoints_fourier(args.net, args.fnet, args.khm,
                                                    rica=not args.no_rica)
    else:
        if not (args.net_t and args.net_f):
            sys.exit("error: --net-t and --net-f are required (or --fnet for the "
                     "legacy Fourier trio)")
        params = load_reference_checkpoints(args.net, args.net_t, args.net_f, args.khm,
                                            rica=not args.no_rica)
    save_checkpoint(args.out, {"params": params}, step=0,
                    extras={"source": "torch-reference",
                            "fourier_variant": bool(args.fnet)})
    print(f"imported reference checkpoints -> {args.out}")


def cmd_demo(args):
    """A synthetic fringe spectrogram as a pseudocolor PNG (the reference's
    display_colors.py demo; reference: src/display_colors.py:27-51)."""
    import numpy as np

    from lshm_tpu_torch.data.synthetic import synth_fringe
    from lshm_tpu_torch.utils.rgb import channel_to_rgb, save_image_grid

    rng = np.random.default_rng(args.seed)
    uv_m = rng.uniform(-1e3, 1e3, size=2)
    vis = synth_fringe(rng, args.ntime, args.nfreq, uv_m, noise=0.05)
    # 4 channels: re/im of pols 0 and 3
    x = np.stack(
        [vis[:, :, 0, 0], vis[:, :, 0, 1], vis[:, :, 3, 0], vis[:, :, 3, 1]], axis=-1
    )
    save_image_grid([channel_to_rgb(x)], args.out)
    print(f"wrote {args.out}")


def cmd_graph(args):
    """Train a GNN classifier over the learned latents, the CLI form of the reference's
    train_graph.py (line graph) / train_graph_stat.py (station graph)."""
    from lshm_tpu_torch.data import read_metadata, scan_files
    from lshm_tpu_torch.graph import (
        build_line_graph_data,
        build_station_graph_data,
        draw_graph,
        station_graph_maps,
        train_line_graph,
        train_station_graph_epochs,
    )

    cfg = _build_config(args)
    t = _loaded_trainer(cfg, args.ckpt)
    files, saps = scan_files(cfg.data.data_dir, cfg.data.file_pattern)
    if not files:
        sys.exit(f"no valid H5 data under {cfg.data.data_dir!r}")
    idx = args.sap_index % len(files)
    shape = dict(patch_size=cfg.data.patch_size, num_channels=cfg.data.num_channels,
                 order=cfg.model.khm_order, device=t.device)

    # a station "epoch" is a full graph rebuild (SAP read + forward sweep), far more
    # costly than a line-graph Adam epoch, so the defaults differ per kind
    if args.epochs is None:
        args.epochs = 200 if args.kind == "line" else 5

    if args.kind == "line":
        data = build_line_graph_data(t.model, files[idx], saps[idx], **shape)
        if args.plot:
            print(f"wrote {draw_graph(data, args.plot, title='baseline line graph')}")
        _, losses = train_line_graph(data, hidden=args.hidden, epochs=args.epochs,
                                     device=t.device)
        print(f"line graph: {data.x.shape[0]} nodes, "
              f"{data.edge_index.shape[1]} edges; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    else:
        baselines_per_sap = [
            read_metadata(f, s, give_baselines=True)[0] for f, s in zip(files, saps)
        ]
        stations, bmap = station_graph_maps(baselines_per_sap)
        if args.plot:
            data = build_station_graph_data(t.model, files[idx], saps[idx], stations, bmap,
                                            **shape)
            print(f"wrote {draw_graph(data, args.plot, title='station graph', directed=True)}")
        # per-epoch stochastic rebuild: each epoch draws a random SAP and a fresh
        # random patch per baseline (reference: src/train_graph_stat.py:161-268)
        _, losses = train_station_graph_epochs(
            t.model, files, saps, stations, bmap,
            epochs=args.epochs, steps_per_graph=args.steps_per_graph, **shape,
        )
        print(f"station graph: {len(stations)} stations, {args.epochs} rebuilt "
              f"graphs x {args.steps_per_graph} steps; "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")


def cmd_rica(args):
    """RICA linear dictionary learning over spectrogram patches, the CLI form of the
    reference's rica_lofar.py script (reference: src/rica_lofar.py:44-104): per
    minibatch, decoded on the host (``sample()``: the native decoder where it builds),
    an L-BFGS sparse-code solve for X = A S and a dictionary ascent step; then the
    learned atoms as one PNG grid.  A ``torch.Generator`` seeded with ``--seed`` draws
    each initial code."""
    import torch

    from lshm_tpu_torch.config import DataConfig, LBFGSConfig
    from lshm_tpu_torch.data import MinibatchSampler, scan_files
    from lshm_tpu_torch.rica import RICAConfig, RICADictionaryLearner

    files, saps = scan_files(args.data_dir)
    if not files:
        sys.exit(f"no valid H5 data under {args.data_dir!r}")
    dcfg = DataConfig(
        data_dir=args.data_dir, batch_size=args.batch, patch_size=args.patch_size,
        num_channels=args.channels, uvdist=False,
    )
    sampler = MinibatchSampler(files, saps, dcfg, seed=args.seed)
    cfg = RICAConfig(
        input_dim=args.channels * args.patch_size * args.patch_size,
        dict_size=args.dict_size, l1_weight=args.l1, dict_lr=args.eta,
        solver=LBFGSConfig(lr=1.0, max_iter=args.solver_iters, history_size=7,
                           line_search=True, batch_mode=True),
    )
    learner = RICADictionaryLearner(cfg, seed=args.seed, device=_device())
    gen = torch.Generator().manual_seed(args.seed)
    for i in range(args.iters):
        mb = sampler.sample()
        X = learner.patches_to_columns(mb.x)
        m = learner.fit_minibatch(X, gen)
        print(f"rica {i} loss {m['loss']:.6e} |dA| {m['dA_norm']:.6e}")
    os.makedirs(args.out, exist_ok=True)
    learner.save_atom_images(args.out, channels=args.channels, patch=args.patch_size)
    print(f"wrote {os.path.join(args.out, 'dictionary_atoms.png')} "
          f"({cfg.dict_size} atoms)")


def cmd_export(args):
    """The trained forward, parameters in the program, as a ``torch.export`` artifact
    that a process importing ``lshm_tpu_torch`` loads and calls without model code."""
    from lshm_tpu_torch.eval import export_forward

    cfg = _build_config(args)
    t = _loaded_trainer(cfg, args.ckpt)
    blob = export_forward(
        t.model,
        patch_size=cfg.data.patch_size, num_channels=cfg.data.num_channels,
        order=cfg.model.khm_order,
        batch_size=args.batch if args.batch > 0 else None,
    )
    with open(args.out, "wb") as f:
        f.write(blob)
    shape = args.batch if args.batch > 0 else "symbolic"
    print(f"exported forward (batch={shape}) -> {args.out} ({len(blob)} bytes)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lshm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help="write a synthetic MS_extract.h5")
    p.add_argument("--out", required=True)
    p.add_argument("--nstations", type=int, default=6)
    p.add_argument("--ntime", type=int, default=192)
    p.add_argument("--nfreq", type=int, default=192)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("train", help="train the cascaded AE + KHM model")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--preset", default="full_khm", choices=PRESETS)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the first epoch here")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: rank 0's address (default: MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: number of processes (default: WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank (default: RANK)")
    _add_set(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="clustering evaluation report")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--preset", default="full_khm")
    p.add_argument("--sap-index", type=int, default=0)
    p.add_argument("--hard-clusters", type=int, default=10)
    p.add_argument("--montages", action="store_true")
    p.add_argument("--recon-panels", action="store_true",
                   help="per-baseline [x|xhat]/[x2|x3]/[xrec|xerr] pseudocolor panels")
    _add_set(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("import-torch", help="convert reference .model checkpoints")
    p.add_argument("--net", required=True)
    p.add_argument("--net-t", default=None)
    p.add_argument("--net-f", default=None)
    p.add_argument("--fnet", default=None,
                   help="legacy Fourier-space AE (net/fnet/khm trio, Demo.ipynb)")
    p.add_argument("--khm", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--no-rica", action="store_true")
    p.set_defaults(fn=cmd_import_torch)

    p = sub.add_parser("graph", help="train a GNN over learned latents")
    p.add_argument("kind", choices=["line", "station"])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--preset", default="full_khm")
    p.add_argument("--sap-index", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-graph", type=int, default=20)
    p.add_argument("--hidden", type=int, default=4)
    p.add_argument("--plot", default=None, metavar="PNG")
    _add_set(p)
    p.set_defaults(fn=cmd_graph)

    p = sub.add_parser("demo", help="render a synthetic fringe spectrogram PNG")
    p.add_argument("--out", default="fringe.png")
    p.add_argument("--ntime", type=int, default=128)
    p.add_argument("--nfreq", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("rica", help="learn a RICA sparse dictionary over patches")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="rica_out")
    p.add_argument("--iters", type=int, default=10,
                   help="minibatches (reference runs 80 epochs x 100 iters)")
    p.add_argument("--batch", type=int, default=8, help="baselines per minibatch "
                   "(reference default_batch=128, src/rica_lofar.py:23)")
    p.add_argument("--patch-size", type=int, default=128)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--dict-size", type=int, default=256, metavar="M")
    p.add_argument("--l1", type=float, default=0.1, help="lambda1 sparsity weight")
    p.add_argument("--eta", type=float, default=0.1, help="dictionary ascent rate")
    p.add_argument("--solver-iters", type=int, default=10,
                   help="L-BFGS max_iter per sparse-code solve")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_rica)

    p = sub.add_parser("export", help="serialize the trained forward (torch.export)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default="lshm_forward.pt2")
    p.add_argument("--preset", default="full_khm")
    p.add_argument("--batch", type=int, default=0,
                   help="static batch size; 0 = symbolic (any batch)")
    _add_set(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="run the headline benchmark "
                                     "(not ported: ROADMAP C.8)")
    p.set_defaults(fn=_not_ported("the bench subcommand",
                                  "C.8, a benchmark of the port"))
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
