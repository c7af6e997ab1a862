"""Default config schema (port of parq_tpu/config/defaults.py): the JAX
package's tree key for key, so the shipped YAMLs load unchanged, with its
`get_cfg`, `update_config` and `check_config`.

The port reads the TPU section where a key has a meaning on the card
(`platform_device`, `check_card_support`): PLATFORM chooses the device,
COMPUTE_DTYPE, IMAGE_SIZE, FPN_CHANNELS, BATCHED_GRAD, REMAT, DEBUG_NANS
and PROFILE_STEPS are honoured; the keys of TPU levers are accepted and
logged as not applying (the hand-written kernels always run).
"""
import logging
import os

from .node import CfgNode as CN

_C = CN()

# general
_C.SEED = 100
_C.MEMORY_GB = 230
_C.CHECKPOINT_PATH = None
_C.DEMO = False
_C.PRETRAINED_PATH = None
_C.NAME = "release"
_C.LOG_PATH = "./parq_logs"
_C.TAG = ""
_C.LOG_IMAGES = True
_C.LOG_IMAGES_FREQUENCY = 4800
_C.LOG_RANK_ZERO_ONLY = True

# trainer (names kept for YAML compat; GPUS means "devices")
_C.TRAINER = CN()
_C.TRAINER.PROFILER = "simple"
_C.TRAINER.ACCELERATOR = "tpu"
_C.TRAINER.GPUS = 1
_C.TRAINER.NUM_NODES = 1
_C.TRAINER.ACCUMULATE_GRAD_BATCHES = 1
_C.TRAINER.MAX_EPOCHS = 100
_C.TRAINER.LOG_EVERY_N_STEPS = 100
_C.TRAINER.GRADIENT_CLIP_VAL = 1.0
_C.TRAINER.RELOAD_DATALOADERS_EVERY_N_EPOCHS = 0
_C.TRAINER.REPLACE_SAMPLER_DDP = True
_C.TRAINER.OVERFIT_BATCHES = 0.0
_C.TRAINER.AUTO_SCALE_BATCH_SIZE = "binsearch"
_C.TRAINER.CHECK_VAL_EVERY_N_EPOCH = 1
_C.TRAINER.PRECISION = 32
_C.TRAINER.VAL_CHECK_INTERVAL = 1.0
_C.TRAINER.LIMIT_VAL_BATCHES = 1.0
_C.TRAINER.LIMIT_TRAIN_BATCHES = 1.0

# callback (checkpoint retention)
_C.CALLBACK = CN()
_C.CALLBACK.MONITOR = "val/metrics/0.5_f1"
_C.CALLBACK.SAVE_TOP_K = 3
_C.CALLBACK.SAVE_LAST = True
_C.CALLBACK.VERBOSE = False
_C.CALLBACK.DIRPATH = None
_C.CALLBACK.FILENAME = None
_C.CALLBACK.AUTO_INSERT_METRIC_NAME = False
_C.CALLBACK.MODE = "max"

# optimizer
_C.OPTIMIZER = CN()
_C.OPTIMIZER.NAME = "adamw"
_C.OPTIMIZER.LEARNING_RATE = 1e-4
_C.OPTIMIZER.CYCLE_MULT = 1
_C.OPTIMIZER.WARMUP_EPOCHS = 0
_C.OPTIMIZER.NUM_RESTARTS = 1
_C.OPTIMIZER.IGNORE_FROZEN_PARAMS = True
_C.OPTIMIZER.AUTOSCALE_LR = True

# datamodule
_C.DATAMODULE = CN()
_C.DATAMODULE.DATASET = "scannet"   # scannet | arkitscenes | synthetic | demo
_C.DATAMODULE.DATA_PATH = "./data/scannet/scans"
_C.DATAMODULE.TRAIN_ANNOTATION_PATH = "./data/scannet/scan2cad_box3d_anno_view3_overlap/scannet_train_gt_roidb.pkl"
_C.DATAMODULE.VAL_ANNOTATION_PATH = "./data/scannet/scan2cad_box3d_anno_view3_overlap/scannet_val_gt_roidb.pkl"
_C.DATAMODULE.BATCH_SIZE = 1
_C.DATAMODULE.NUM_WORKERS = 1
_C.DATAMODULE.NUM_FRAMES_PER_SNIPPET = 3
_C.DATAMODULE.SHUFFLE = True
_C.DATAMODULE.GRAVITY_ALIGNED = True

# model
feature_dim = 1024
_C.MODEL = CN()
_C.MODEL.BACKBONE2D = CN()
_C.MODEL.BACKBONE2D.RESNET_NAME = "resnet50"
_C.MODEL.BACKBONE2D.LAYER = 0
_C.MODEL.BACKBONE2D.FREEZE = False

_C.MODEL.TOKENIZER = CN()
_C.MODEL.TOKENIZER.OUT_CHANNELS = feature_dim
_C.MODEL.TOKENIZER.PATCH_SIZE = 1
_C.MODEL.TOKENIZER.RAY_POINTS_SCALE = [-2, 2, -1.5, 0, 0.25, 4.25]
_C.MODEL.TOKENIZER.NUM_SAMPLES = 64
_C.MODEL.TOKENIZER.MIN_DEPTH = 0.25
_C.MODEL.TOKENIZER.MAX_DEPTH = 5.25

_C.MODEL.DECODER = CN()
_C.MODEL.DECODER.DIM_IN = feature_dim
_C.MODEL.DECODER.NUM_QUERIES = 128
_C.MODEL.DECODER.NUM_SEMCLS = 9
_C.MODEL.DECODER.BOX_SIZE = [1, 1, 1]
_C.MODEL.DECODER.LOSS_WEIGHT = [5.0, 5.0, 5.0, 1.0]
_C.MODEL.DECODER.CONF_THRESH = 0.1
_C.MODEL.DECODER.MEAN_SIZE_PATH = None
_C.MODEL.DECODER.EVAL_TYPE = "f1"
_C.MODEL.DECODER.ENABLE_NMS = True
_C.MODEL.DECODER.SHARE_MLP_HEADS = True
_C.MODEL.DECODER.FOR_VIS = False
_C.MODEL.DECODER.TRACK_SCALE = [-1.5, 1.5, -2, 1, 0, 2]

_C.MODEL.DECODER.TRANSFORMER = CN()
_C.MODEL.DECODER.TRANSFORMER.DEC_DIM = feature_dim
_C.MODEL.DECODER.TRANSFORMER.DEC_HEADS = 4
_C.MODEL.DECODER.TRANSFORMER.DEC_FFN_DIM = 768
_C.MODEL.DECODER.TRANSFORMER.DEC_LAYERS = 8
_C.MODEL.DECODER.TRANSFORMER.DROPOUT_RATE = 0.1
_C.MODEL.DECODER.TRANSFORMER.QUERIES_DIM = feature_dim
_C.MODEL.DECODER.TRANSFORMER.SCALE = [-2, 2, -1.5, 0, 0.25, 4.25]
_C.MODEL.DECODER.TRANSFORMER.SHARE_WEIGHTS = True

# The JAX package's TPU section, key for key. On the card: PLATFORM "cpu"
# (or env PARQ_PLATFORM=cpu) runs the plain versions on the CPU, anything
# else CUDA; COMPUTE_DTYPE, IMAGE_SIZE, FPN_CHANNELS, BATCHED_GRAD, REMAT
# (recompute each decoder iteration in the backward), DEBUG_NANS (stop at
# the first non-finite value) and PROFILE_STEPS (a torch.profiler trace of
# N train steps into <workdir>/profile) are honoured; see
# `check_card_support` for the rest.
_C.TPU = CN()
_C.TPU.PLATFORM = ""
_C.TPU.MESH_DATA = -1
_C.TPU.MESH_MODEL = 1
_C.TPU.SEQ_PARALLEL = False
_C.TPU.COMPUTE_DTYPE = "float32"   # "bfloat16" for the fast path
_C.TPU.PARAM_DTYPE = "float32"
_C.TPU.USE_PALLAS_SAMPLER = True
_C.TPU.USE_FLASH_CROSS_ATTN = True
_C.TPU.BATCHED_GRAD = True         # fold decoder iterations for the backward
_C.TPU.REMAT = False
_C.TPU.ASYNC_CHECKPOINTING = True
_C.TPU.IMAGE_SIZE = [320, 240]     # static (W, H) model input
_C.TPU.FPN_CHANNELS = 256          # per-level FPN width (concat = 4x this)
_C.TPU.DONATE_TRAIN_STATE = True
_C.TPU.PROFILE_STEPS = 0
_C.TPU.DEBUG_NANS = False
_C.TPU.RNG_IMPL = "rbg"


def get_cfg() -> CN:
    return _C.clone()


def update_config(cfg: CN, args) -> None:
    """yacs-style: merge file then CLI list, check, freeze."""
    cfg.defrost()
    cfg.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    check_config(cfg)
    cfg.freeze()


# TRAINER.PRECISION values and their compute dtype; 16 means bf16, as in
# the JAX package.
_PRECISION_DTYPE = {32: "float32", "32": "float32",
                    16: "bfloat16", "16": "bfloat16",
                    "bf16": "bfloat16", "bf16-mixed": "bfloat16",
                    "16-mixed": "bfloat16"}


def check_config(cfg: CN) -> None:
    """Validate and resolve knobs after merging, as the JAX package does
    (same rejections, same messages)."""
    t = cfg.TRAINER
    if t.PRECISION not in _PRECISION_DTYPE:
        raise ValueError(
            f"TRAINER.PRECISION={t.PRECISION!r} is not supported on TPU; "
            f"use one of {sorted(map(str, _PRECISION_DTYPE))}")
    want = _PRECISION_DTYPE[t.PRECISION]
    if want != "float32" and cfg.TPU.COMPUTE_DTYPE == "float32":
        cfg.TPU.COMPUTE_DTYPE = want
    if t.RELOAD_DATALOADERS_EVERY_N_EPOCHS != 0:
        raise ValueError(
            "TRAINER.RELOAD_DATALOADERS_EVERY_N_EPOCHS is not supported: "
            "SnippetLoader rebuilds its (reshuffled) epoch order every "
            "epoch already — remove the key")
    if t.AUTO_SCALE_BATCH_SIZE not in ("binsearch", False, None, ""):
        raise ValueError(
            "TRAINER.AUTO_SCALE_BATCH_SIZE is not supported (it is inert "
            "in the reference as well): set DATAMODULE.BATCH_SIZE "
            "explicitly")
    if int(t.CHECK_VAL_EVERY_N_EPOCH) < 1:
        raise ValueError("TRAINER.CHECK_VAL_EVERY_N_EPOCH must be >= 1")
    if bool(cfg.TPU.SEQ_PARALLEL):
        if int(cfg.TPU.MESH_MODEL) <= 1:
            raise ValueError(
                "TPU.SEQ_PARALLEL requires TPU.MESH_MODEL > 1 (the token "
                "axis shards over the model mesh axis)")
        if not bool(cfg.TPU.USE_FLASH_CROSS_ATTN):
            raise ValueError(
                "TPU.SEQ_PARALLEL requires TPU.USE_FLASH_CROSS_ATTN: the "
                "sharded attention runs only through the SP flash variants")


def platform_device(cfg: CN) -> str:
    """"cpu" when env PARQ_PLATFORM or TPU.PLATFORM says so, else "cuda"
    (`parq_torch.resolve_device` then raises without a GPU)."""
    platform = os.environ.get("PARQ_PLATFORM", "") or str(cfg.TPU.PLATFORM)
    platform = platform.lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    raise ValueError(f"TPU.PLATFORM / PARQ_PLATFORM={platform!r}: the port "
                     "runs on 'cuda' (the default) or 'cpu'")


# TPU levers with no counterpart on the card: accepted and logged.
# PARAM_DTYPE is one: the JAX package reads it nowhere
# (parq_tpu/config/defaults.py:127 is its only mention), so its parameters
# are float32 whatever it says, and the port's are too. REMAT,
# DEBUG_NANS and MODEL.DECODER.TRANSFORMER.SHARE_WEIGHTS are honoured
# (models/decoder.py, train/loop.py), as are MESH_DATA, MESH_MODEL,
# SEQ_PARALLEL and NUM_NODES (the Trainer's (data, model) grid).
_TPU_LEVERS = ("USE_PALLAS_SAMPLER", "USE_FLASH_CROSS_ATTN",
               "DONATE_TRAIN_STATE", "ASYNC_CHECKPOINTING", "RNG_IMPL",
               "PARAM_DTYPE")


def check_card_support(cfg: CN) -> None:
    """Log the TPU levers, which do not apply on the card. Every key of
    the schema is honoured or is one of them, so no config the JAX package
    runs is refused."""
    logging.getLogger(__name__).info(
        "TPU levers that do not apply on the card (the hand-written kernels "
        "always run; parameters are float32): %s",
        ", ".join(f"{k}={cfg.TPU[k]!r}" for k in _TPU_LEVERS))
