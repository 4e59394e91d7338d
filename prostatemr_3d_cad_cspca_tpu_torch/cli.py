"""Training CLI, port of the JAX package's ``cli.py``: flag-for-flag the
reference training script (tf2.5/scripts/train_model.py:43-97) on one NVIDIA
GPU.

    python -m prostatemr_3d_cad_cspca_tpu_torch.cli --TRAIN_OBJ lesion \\
      --TRAIN_XLSX_PREFIX feed/train-fold- --VALID_XLSX_PREFIX feed/valid-fold- \\
      --WEIGHTS_DIR weights/ --NAME run1 [--DEVICE cuda|cpu]

  * per-fold loop with completed-fold skip (train_model.py:101-104)
  * manifest loading (xlsx/csv/tsv), shapes derived from the first sample
    (train_model.py:107-110, 144-151)
  * CALR/CLR schedule + Adam-amsgrad/SGD-nesterov (train_model.py:113-121)
  * focal / dice+boundary (+ ELBO-KL) losses (train_model.py:124-131)
  * the CLI's augmentation on the device inside the train step
    (train_model.py:175-183)
  * WeightsSaver / ResumeTraining semantics (train_model.py:222-251), and
    full-state checkpoints under ``<fold>/checkpoints``
    (``--ORBAX_CHECKPOINTS``, keep 3)

The JAX parser's flags with their defaults, plus ``--DEVICE`` ('cuda', the
default, or 'cpu' for the plain PyTorch path; without a card the CLI
raises unless asked for the CPU).

Several devices train data-parallel (``parallel``, ``train.trainer``):
``initialize_distributed()`` runs first, so a world set up by the
environment (``PROSTATEMR_COORDINATOR``/``_NUM_PROCESSES``/``_PROCESS_ID``,
or ``PROSTATEMR_MULTIHOST=1`` under ``torchrun``) trains one rank a card.
Otherwise ``--GPU_DEVICE_IDs 0,1`` (or 'all' on a machine with several
cards) spawns one worker a named card, joined over a TCP store on
localhost with NCCL; ``--DEVICE cpu --GPU_DEVICE_IDs 0,1`` spawns two gloo
workers on the CPU (JAX's forced host devices). Every rank reads the same
global batches and keeps its rows; only rank 0 writes weights,
checkpoints, metrics and history.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    prsr = argparse.ArgumentParser(
        description="Command Line Arguments for Training Script")
    # Dataset definition (reference train_model.py:46-64)
    prsr.add_argument("--TRAIN_OBJ", type=str, default="lesion")
    prsr.add_argument("--NAME", type=str, default="diagnosis/")
    prsr.add_argument("--NUM_EPOCHS", type=int, default=250)
    prsr.add_argument("--FOLDS", type=int, default=[0, 1, 2, 3, 4], nargs="+")
    prsr.add_argument("--TRAIN_XLSX_PREFIX", type=str,
                      default="./feed/prostateX_200_train-fold-")
    prsr.add_argument("--VALID_XLSX_PREFIX", type=str,
                      default="./feed/prostateX_200_valid-fold-")
    prsr.add_argument("--WEIGHTS_DIR", type=str, default="./weights/")
    prsr.add_argument("--METRICS_DIR", type=str, default="./weights/")
    prsr.add_argument("--USE_PRETRAINED_WEIGHTS", type=str, default="False")
    prsr.add_argument("--FREEZE_LAYERS", type=int, default=9999)
    prsr.add_argument("--WEIGHTS_MIN_EPOCH", type=int, default=5)
    prsr.add_argument("--VALIDATE_PER_N_EPOCHS", type=int, default=5)
    prsr.add_argument("--STORE_WEIGHTS_PER_N_EPOCHS", type=int, default=5)
    prsr.add_argument("--WEIGHTS_OVERWRITE", type=int, default=0)
    prsr.add_argument("--VALIDATE_MIN_EPOCH", type=int, default=5)
    prsr.add_argument("--SHOW_SUMMARY", type=int, default=0)
    prsr.add_argument("--RESUME_TRAIN", type=int, default=0)
    prsr.add_argument("--ORBAX_CHECKPOINTS", type=int, default=1,
                      help="full-state (params+optimizer) checkpoints under "
                           "<fold>/checkpoints, auto-resumed; 0 = npz "
                           "WeightsSaver only (the flag keeps the JAX CLI's name)")
    prsr.add_argument("--CACHE_TDS_PATH", type=str, default=None)
    prsr.add_argument("--GPU_DEVICE_IDs", type=str, default="all",
                      help="the cards to train on, data-parallel: 'all' or a comma "
                           "list of ids (with --DEVICE cpu: that many CPU workers)")
    prsr.add_argument("--PRECISION", type=str, default="fp32",
                      choices=["fp32", "bf16"],
                      help="compute precision (params/optimizer stay fp32)")
    # U-Net hyperparameters (reference train_model.py:67-80)
    prsr.add_argument("--UNET_DENSE_SKIP", type=int, default=0)
    prsr.add_argument("--UNET_DEEP_SUPERVISION", type=int, default=0)
    prsr.add_argument("--UNET_PROBABILISTIC", type=int, default=0)
    prsr.add_argument("--UNET_PROBA_LATENT_DIMS", type=int, default=[3, 2, 1, 0], nargs="+")
    prsr.add_argument("--UNET_PROBA_ITER", type=int, default=1)
    prsr.add_argument("--UNET_FEATURE_CHANNELS", type=int,
                      default=[16, 32, 64, 128, 256], nargs="+")
    prsr.add_argument("--UNET_STRIDES", type=str,
                      default="(1,1,1),(1,2,2),(1,2,2),(2,2,2),(2,2,2)")
    prsr.add_argument("--UNET_KERNEL_SIZES", type=str,
                      default="(1,3,3),(1,3,3),(3,3,3),(3,3,3),(3,3,3)")
    prsr.add_argument("--UNET_ATT_SUBSAMP", type=str,
                      default="(1,1,1),(1,1,1),(1,1,1),(1,1,1)")
    prsr.add_argument("--UNET_SE_REDUCTION", type=int, default=[8, 8, 8, 8, 8], nargs="+")
    prsr.add_argument("--UNET_KERNEL_REGULARIZER_L2", type=float, default=1e-5)
    prsr.add_argument("--UNET_BIAS_REGULARIZER_L2", type=float, default=1e-5)
    prsr.add_argument("--UNET_DROPOUT_MODE", type=str, default="monte-carlo")
    prsr.add_argument("--UNET_DROPOUT_RATE", type=float, default=0.50)
    # Training hyperparameters (reference train_model.py:83-95)
    prsr.add_argument("--BATCH_SIZE", type=int, default=2)
    prsr.add_argument("--BASE_LR", type=float, default=1e-3)
    prsr.add_argument("--LR_MODE", type=str, default="CALR")
    prsr.add_argument("--CALR_PARAMS", type=float, default=[2.00, 1.00, 1e-3], nargs="+")
    prsr.add_argument("--CLR_PARAMS", type=float, default=[5e-5, 1.00, 1.25], nargs="+")
    prsr.add_argument("--OPTIMIZER", type=str, default="adam")
    prsr.add_argument("--LOSS_MODE", type=str, default="distribution_focal")
    prsr.add_argument("--FOCAL_LOSS_ALPHA", type=float, default=[1.00, 1.00], nargs="+")
    prsr.add_argument("--FOCAL_LOSS_GAMMA", type=float, default=2.0)
    prsr.add_argument("--DSC_BD_LOSS_WEIGHTS", type=float, default=[0.50, 0.50], nargs="+")
    prsr.add_argument("--ELBO_LOSS_PARAMS", type=float, default=[10], nargs="+")
    prsr.add_argument("--AUGM_PARAMS", type=str,
                      default="1.00,0.25,0.15,10.0,1,1.20,0.10,0.025,1,0.50,1.50")
    prsr.add_argument("--DEVICE", type=str, default="cuda",
                      help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return prsr


def _parse_tuples(s: str):
    """'(1,1,1),(1,2,2),...' -> ((1,1,1),(1,2,2),...)"""
    s = s.replace(" ", "")
    return tuple(tuple(int(v) for v in part.split(","))
                 for part in s.strip("()").split("),("))


def _parse_augm(s: str) -> List:
    vals = [float(v) for v in s.replace(" ", "").split(",")]
    return [vals[0], vals[1], vals[2], vals[3], bool(vals[4]), vals[5],
            vals[6], vals[7], bool(vals[8]), (vals[9], vals[10])]


def _spawned(rank: int, argv, port: int, devices):
    """One worker of a spawned world: join it, then train as its rank."""
    import torch
    import torch.distributed as dist

    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=len(devices), rank=rank)
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def _spawn(argv, devices):
    """One worker a device, joined over a TCP store on a free localhost
    port; returns when all have finished (a failed worker raises)."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp.start_processes(_spawned, args=(argv, port, devices), nprocs=len(devices),
                        start_method="spawn")


def _world_devices(args):
    """Each rank's device in a world: the CPU with --DEVICE cpu, else the
    rank's card (its LOCAL_RANK-th id of --GPU_DEVICE_IDs, or card
    LOCAL_RANK)."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    if str(args.DEVICE).startswith("cpu"):
        return [torch.device("cpu")] * world
    ids = ([] if args.GPU_DEVICE_IDs in ("all", "", None)
           else [int(i) for i in str(args.GPU_DEVICE_IDs).split(",")])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(torch.cuda.device_count(), 1)
    return [torch.device("cuda", ids[r % local] if ids else r % local) for r in range(world)]


def main(argv=None):
    args, _ = build_parser().parse_known_args(argv)
    from .parallel.mesh import (assert_batch_divisible, initialize_distributed, make_mesh,
                                setup_device)

    # a world the environment sets up (no-op for one process)
    initialize_distributed(backend="gloo" if str(args.DEVICE).startswith("cpu") else None)
    import torch.distributed as dist

    if dist.is_initialized():
        devices = _world_devices(args)
        mesh = make_mesh(n_data=dist.get_world_size(), devices=devices)
        device, n_dev = mesh.device, mesh.size
    else:
        devices, n_dev = setup_device(args.GPU_DEVICE_IDs, args.DEVICE)
        if n_dev > 1:
            return _spawn(argv if argv is not None else sys.argv[1:], devices)
        mesh, device = None, devices[0]
    writer = mesh is None or mesh.is_writer

    def barrier():
        if mesh is not None:
            dist.barrier(group=mesh.group)

    import torch

    from .data.generators import batch_iterator, custom_data_generator, load_sample
    from .data.manifest import read_manifest
    from .models.m1 import M1
    from .train.checkpoint import CheckpointManager
    from .train.trainer import (build_schedule, fit, make_loss, make_optimizer,
                                resume_training)
    from .train.validation import AnatomySegmentationValidation, PCaDetectionValidation
    from .utils.overview import print_overview
    from .utils.profiling import MetricsLogger

    for f in args.FOLDS:
        fold_dir = os.path.join(args.WEIGHTS_DIR, args.NAME, f"F{f + 1}")
        final_w = os.path.join(fold_dir, f"model_weights_{args.NUM_EPOCHS:03d}.npz")
        if os.path.isfile(final_w):  # completed-fold skip (train_model.py:102-104)
            continue

        def _manifest_path(prefix: str) -> str:
            # the reference's xlsx fold files (train_model.py:107-108), or
            # csv/tsv manifests with the same columns
            for ext in (".xlsx", ".csv", ".tsv"):
                cand = f"{prefix}{f + 1}{ext}"
                if os.path.isfile(cand):
                    return cand
            raise FileNotFoundError(
                f"No manifest {prefix}{f + 1}.(xlsx|csv|tsv) found")

        train_manifest = _manifest_path(args.TRAIN_XLSX_PREFIX)
        valid_manifest = _manifest_path(args.VALID_XLSX_PREFIX)
        rows = read_manifest(train_manifest)
        n_train = len(rows)
        steps_per_epoch = int(np.ceil(n_train / args.BATCH_SIZE))

        schedule = build_schedule(
            args.LR_MODE, args.BASE_LR, steps_per_epoch, args.NUM_EPOCHS,
            calr_params=args.CALR_PARAMS, clr_params=args.CLR_PARAMS)
        optimizer = make_optimizer(
            args.OPTIMIZER, schedule, freeze_first_n=args.FREEZE_LAYERS)
        seg_loss = make_loss(
            args.LOSS_MODE, focal_alpha=args.FOCAL_LOSS_ALPHA,
            focal_gamma=args.FOCAL_LOSS_GAMMA,
            dsc_bd_weights=args.DSC_BD_LOSS_WEIGHTS)

        if writer:
            print_overview(args)

        image0 = np.load(rows[0]["image_path"])
        spatial_dims = image0[..., 0].shape
        num_channels = 3 if args.TRAIN_OBJ == "lesion" else 1
        num_classes = 2 if args.TRAIN_OBJ == "lesion" else 3
        if args.LOSS_MODE == "distribution_focal" and \
                len(args.FOCAL_LOSS_ALPHA) != num_classes:
            raise Exception(
                "Number of Class Weights Declared in Loss Function != "
                "Number of Classes in Labels/Loss Objective")
        if args.UNET_PROBABILISTIC:
            num_channels += num_classes - 1

        assert_batch_divisible(args.BATCH_SIZE, n_dev)

        sample_gen = custom_data_generator(
            train_manifest, train_obj=args.TRAIN_OBJ,
            probabilistic=bool(args.UNET_PROBABILISTIC), mode="train",
            shuffle_seed=f,
            # boundary loss trains against a pipeline-precomputed signed EDT
            with_dist_map=(args.LOSS_MODE == "region_boundary"),
            cache_dir=args.CACHE_TDS_PATH)
        # augmentation runs on the device inside the train step
        batches = batch_iterator(sample_gen, args.BATCH_SIZE)

        model = M1(
            input_spatial_dims=spatial_dims,
            input_channels=num_channels,
            num_classes=num_classes,
            filters=tuple(args.UNET_FEATURE_CHANNELS),
            dropout_rate=args.UNET_DROPOUT_RATE,
            strides=_parse_tuples(args.UNET_STRIDES),
            kernel_sizes=_parse_tuples(args.UNET_KERNEL_SIZES),
            dropout_mode=args.UNET_DROPOUT_MODE,
            se_reduction=tuple(args.UNET_SE_REDUCTION),
            att_sub_samp=_parse_tuples(args.UNET_ATT_SUBSAMP),
            probabilistic=bool(args.UNET_PROBABILISTIC),
            prob_latent_dims=tuple(args.UNET_PROBA_LATENT_DIMS),
            dense_skip=bool(args.UNET_DENSE_SKIP),
            deep_supervision=bool(args.UNET_DEEP_SUPERVISION),
            summary=bool(args.SHOW_SUMMARY) and writer,
            kernel_regularizer=args.UNET_KERNEL_REGULARIZER_L2,
            bias_regularizer=args.UNET_BIAS_REGULARIZER_L2,
            dtype=(torch.bfloat16 if args.PRECISION == "bf16" else None),
            device=device,
        )

        if str(args.USE_PRETRAINED_WEIGHTS) != "False":
            # warm-start into the constructed architecture (train_model.py:
            # 216-219): head/shape mismatches keep their initialized values
            model.load_weights(args.USE_PRETRAINED_WEIGHTS)

        init_epoch = 0
        if args.RESUME_TRAIN:
            model, init_epoch = resume_training(model, fold_dir)
        else:
            exists = os.path.exists(fold_dir)
            barrier()  # every rank has looked before rank 0 makes it
            if exists:
                raise Exception(
                    "Target Folder Already Exists! Either Remove It or "
                    "Enable 'RESUME_TRAIN'.")
            if writer:
                os.makedirs(fold_dir)
            barrier()

        # Train-time validation (the reference's TBA callbacks,
        # train_model.py:240-245, with UNET_PROBA_ITER MC sampling)
        valid_samples = [
            load_sample(r, args.TRAIN_OBJ, bool(args.UNET_PROBABILISTIC), "valid")
            for r in read_manifest(valid_manifest)
        ]
        detect_fn = model.get_detect_model()
        if args.TRAIN_OBJ == "lesion":
            validate_fn = PCaDetectionValidation(
                detect_fn, valid_samples, proba_iter=args.UNET_PROBA_ITER, device=device)
        else:
            validate_fn = AnatomySegmentationValidation(detect_fn, valid_samples,
                                                        device=device)

        metrics_dir = os.path.join(args.METRICS_DIR, args.NAME, f"F{f + 1}")
        metrics_logger = MetricsLogger(
            os.path.join(metrics_dir, "metrics.jsonl"), echo=False) if writer else None
        checkpoint_manager = None
        if args.ORBAX_CHECKPOINTS:
            if os.path.isdir(os.path.join(fold_dir, "orbax")):
                print(f"{os.path.join(fold_dir, 'orbax')} holds the JAX package's orbax "
                      "checkpoints, which the port does not read; resuming from the "
                      "fold's npz weights", flush=True)
            checkpoint_manager = CheckpointManager(
                os.path.join(fold_dir, "checkpoints"), max_to_keep=3,
                save_interval_steps=args.STORE_WEIGHTS_PER_N_EPOCHS)

        try:
            history = fit(
                model, batches,
                epochs=args.NUM_EPOCHS,
                steps_per_epoch=steps_per_epoch,
                initial_epoch=init_epoch,
                optimizer=optimizer,
                loss=seg_loss,
                loss_weights=[1.0] + ([args.ELBO_LOSS_PARAMS[0]]
                                      if args.UNET_PROBABILISTIC else []),
                weights_dir=fold_dir,
                weights_min_epoch=args.WEIGHTS_MIN_EPOCH,
                store_weights_per_n_epochs=args.STORE_WEIGHTS_PER_N_EPOCHS,
                weights_overwrite=bool(args.WEIGHTS_OVERWRITE),
                validate_fn=validate_fn,
                validate_per_n_epochs=args.VALIDATE_PER_N_EPOCHS,
                validate_min_epoch=args.VALIDATE_MIN_EPOCH,
                augment_params=_parse_augm(args.AUGM_PARAMS),
                train_obj=args.TRAIN_OBJ,
                schedule=schedule,
                metrics_logger=metrics_logger,
                checkpoint_manager=checkpoint_manager,
                mesh=mesh,
            )
        finally:
            batches.close()
            if checkpoint_manager is not None:
                checkpoint_manager.close()
        # the fit history (Keras History parity)
        if writer:
            with open(os.path.join(metrics_dir, "history.json"), "w") as fh:
                json.dump(history, fh, default=float)
        barrier()


if __name__ == "__main__":
    main()
