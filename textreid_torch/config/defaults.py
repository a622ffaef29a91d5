"""Default configuration tree.

Schema-compatible with the reference defaults (`reference/lib/config/
defaults.py:1-144`) so the five reference experiment YAMLs under
`configs/cuhkpedes/` merge without modification, plus a `TPU` section for
mesh/precision/kernel knobs that have no reference counterpart.  The port's
own copy of ``textreid_tpu/config/defaults.py``: same keys, same defaults.
"""

from .node import ConfigNode as CN

_C = CN()
_C.ROOT = "./"

# ---------------------------------------------------------------------------
# Dataset (reference defaults.py:9-12)
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()
_C.DATASETS.USE_ONEHOT = True

# ---------------------------------------------------------------------------
# DataLoader (reference defaults.py:18-22)
# ---------------------------------------------------------------------------
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.IMS_PER_ID = 4
_C.DATALOADER.EN_SAMPLER = True
# Cache decoded images in host RAM across epochs (skips JPEG decode; ~5 GB
# for full CUHK-PEDES at 384x128). Worth enabling on decode-bound hosts.
_C.DATALOADER.CACHE_IMAGES = False

# ---------------------------------------------------------------------------
# Input (reference defaults.py:28-34)
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.HEIGHT = 224
_C.INPUT.WIDTH = 224
_C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
_C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
_C.INPUT.PADDING = 10
_C.INPUT.USE_AUG = False
# Caption token budget. The reference hardcodes 105 in its loader
# (`lib/data/build.py:27`), shadowing GRU.MAX_LENGTH; we surface it here.
_C.INPUT.MAX_TEXT_LENGTH = 105

# ---------------------------------------------------------------------------
# Model (reference defaults.py:40-87)
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.DEVICE = "tpu"
_C.MODEL.VISUAL_MODEL = "resnet50"
_C.MODEL.TEXTUAL_MODEL = "bilstm"
_C.MODEL.NUM_CLASSES = 11003
_C.MODEL.FREEZE = False
_C.MODEL.WEIGHT = "imagenet"

_C.MODEL.MOCO = CN()
_C.MODEL.MOCO.K = 1024
_C.MODEL.MOCO.M = 0.999
_C.MODEL.MOCO.FC = True

_C.MODEL.GRU = CN()
_C.MODEL.GRU.ONEHOT = "yes"
_C.MODEL.GRU.EMBEDDING_SIZE = 512
_C.MODEL.GRU.NUM_UNITS = 512
_C.MODEL.GRU.VOCABULARY_SIZE = 12000
_C.MODEL.GRU.DROPOUT_KEEP_PROB = 0.7
_C.MODEL.GRU.MAX_LENGTH = 100
_C.MODEL.GRU.NUM_LAYER = 1

_C.MODEL.RESNET = CN()
_C.MODEL.RESNET.RES5_STRIDE = 2
_C.MODEL.RESNET.RES5_DILATION = 1
_C.MODEL.RESNET.PRETRAINED = None

_C.MODEL.VIT = CN()
_C.MODEL.VIT.PATCH_SIZE = 16
_C.MODEL.VIT.WIDTH = 768
_C.MODEL.VIT.LAYERS = 12
_C.MODEL.VIT.HEADS = 12
_C.MODEL.VIT.OUTPUT_DIM = 512

# CLIP text-transformer textual tower (MODEL.TEXTUAL_MODEL: "transformer"
# — full-CLIP extension; the reference only ships the bi-GRU branch).
_C.MODEL.TRANSFORMER = CN()
# Named preset ("clip_text_b16", ...; models/text_transformer.py) or empty
# to use the explicit fields below.
_C.MODEL.TRANSFORMER.ARCH = ""
_C.MODEL.TRANSFORMER.WIDTH = 512
_C.MODEL.TRANSFORMER.LAYERS = 12
_C.MODEL.TRANSFORMER.HEADS = 8
_C.MODEL.TRANSFORMER.OUTPUT_DIM = 512
_C.MODEL.TRANSFORMER.VOCAB_SIZE = 49408  # CLIP BPE
_C.MODEL.TRANSFORMER.CONTEXT_LENGTH = 77

_C.MODEL.EMBEDDING = CN()
_C.MODEL.EMBEDDING.EMBED_HEAD = "simple"
_C.MODEL.EMBEDDING.FEATURE_SIZE = 512
_C.MODEL.EMBEDDING.DROPOUT_PROB = 0.3
_C.MODEL.EMBEDDING.EPSILON = 0.0

# ---------------------------------------------------------------------------
# Solver (reference defaults.py:93-120)
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.NUM_EPOCHS = 100
_C.SOLVER.CHECKPOINT_PERIOD = 1
# Keep only the newest N epoch_* checkpoints (0 = keep all, the
# reference's behavior). 'best' is never pruned. An 80-epoch flagship run
# otherwise accumulates ~12 GB of epoch dirs.
_C.SOLVER.CHECKPOINT_KEEP = 0
_C.SOLVER.EVALUATE_PERIOD = 1
# Steps between log lines.  The reference logs every iteration
# (trainer.py:100); each log forces a host sync, so default sparser.
_C.SOLVER.LOG_PERIOD = 20

# Split each global batch into this many sequentially-processed microbatches
# (1 = off, the reference behavior).  This is NOT naive gradient
# accumulation: the batch-contrastive losses (global_align/CMPM and the
# MoCo same-identity queue mask) are computed over the FULL batch's
# embeddings, exactly as if the whole batch ran at once, via a two-pass
# gradient-cache step (engine/grad_cache.py) — embeddings are collected
# per-microbatch, the loss is differentiated w.r.t. those tiny [B, D]
# embeddings once, and the cotangents are backpropagated through each
# microbatch's towers under a lax.scan.  Activation memory is one
# microbatch; compute is ~1 extra tower forward (like TPU.REMAT).  For
# LayerNorm towers (ViT / text transformer) the result is bit-comparable
# to the single-pass step; BatchNorm towers normalize per microbatch
# (documented delta — torch users accumulating grads get the same).
_C.SOLVER.GRAD_ACCUM_STEPS = 1

_C.SOLVER.OPTIMIZER = "Adam"
_C.SOLVER.BASE_LR = 0.0002
_C.SOLVER.BIAS_LR_FACTOR = 2

_C.SOLVER.WEIGHT_DECAY = 0.00004
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0

_C.SOLVER.ADAM_ALPHA = 0.9
_C.SOLVER.ADAM_BETA = 0.999
_C.SOLVER.SGD_MOMENTUM = 0.9

_C.SOLVER.LRSCHEDULER = "step"

_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_EPOCHS = 10
_C.SOLVER.WARMUP_METHOD = "linear"

_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (500,)

_C.SOLVER.POWER = 0.9
_C.SOLVER.TARGET_LR = 0.0001

# LR multiplier for the pretrained visual tower (an extension, no
# reference counterpart — defaults to 1.0 = reference behavior).  The ViT
# fine-tune recipe trains the interpolated-pos-embed CLIP tower at a
# fraction of BASE_LR while the GRU/head train at full rate
# (configs/cuhkpedes/moco_gru_clipvitb16_ft_ls_bs128_2048.yaml).
_C.SOLVER.VISUAL_LR_FACTOR = 1.0

# ---------------------------------------------------------------------------
# Test (reference defaults.py:126-130)
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.IMS_PER_BATCH = 16

# ---------------------------------------------------------------------------
# Precision (reference defaults.py:142-144; AMP_VERBOSE kept for compat)
# ---------------------------------------------------------------------------
_C.DTYPE = "float32"
_C.AMP_VERBOSE = False

# ---------------------------------------------------------------------------
# Accelerator knobs.  The key tree is the JAX package's, names included, so
# every YAML under configs/ loads unchanged in both packages.  The port
# reads COMPUTE_DTYPE, FUSED_ATTENTION, DEBUG_NANS and ALLOW_RANDOM_VOCAB;
# the other keys are accepted and have no effect here yet.
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Data-parallel axis size. 0 = all visible devices.
_C.TPU.DATA_PARALLEL = 0
# Tensor-parallel degree for the transformer towers; 1 = off.
_C.TPU.MODEL_PARALLEL = 1
# Multi-slice pod count.
_C.TPU.NUM_SLICES = 1
# Shard the optimizer's moment mirrors over the data axis.
_C.TPU.OPTIMIZER_SHARDING = False
# Compute dtype for backbone matmuls/convs: "float32" or "bfloat16".
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Text-tower recurrence on the fused scan kernel (the JAX package's switch;
# the port always launches its kernels on a CUDA tensor).
_C.TPU.GRU_PALLAS = False
# Transformer towers compute attention with the fused kernel
# (ops/attention.py): the [S, S] score tile never reaches device memory.
_C.TPU.FUSED_ATTENTION = False
# Per-tower lowering of the fused attention in the JAX package.
_C.TPU.FUSED_ATTENTION_MODE = "on"
_C.TPU.FUSED_ATTENTION_TEXT_MODE = "off"
_C.TPU.FUSED_ATTENTION_LAYOUT = "auto"
# Ship uint8 pixels and fuse /255 -> normalize -> random-erase fill into the
# device step (4x less host->device traffic than f32). False restores the
# reference's all-host float pipeline.
_C.TPU.DEVICE_PREP = True
# Donate train-state buffers to the step.
_C.TPU.DONATE_STATE = True
# Overlap checkpoint writes with training.
_C.TPU.ASYNC_CHECKPOINT = True
# Rematerialize the query image-encoder forward in the backward pass.
_C.TPU.REMAT = False
# Raise on non-finite training losses at every log boundary.
_C.TPU.DEBUG_NANS = False
# SIGTERM-safe training: save a 'preempt' checkpoint and exit 0.
_C.TPU.PREEMPT_SAVE = True
# Persistent compilation cache directory ("" = off).
_C.TPU.COMPILATION_CACHE_DIR = ""
# Multi-host input sharding: each process decodes only its slice of every
# global train batch.
_C.TPU.PROCESS_SHARD_DATA = True
# Permit a FIXED RANDOM frozen vocab table when the .npy file is missing
# (synthetic/smoke runs only). Off by default: a real run with a mistyped
# --root must fail loudly, not train to garbage.
_C.TPU.ALLOW_RANDOM_VOCAB = False

_C.SEED = 0


def get_default_cfg() -> CN:
    return _C.clone()
