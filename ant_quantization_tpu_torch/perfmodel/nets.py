"""Benchmark network layer tables for the accelerator model.

TPU-native equivalent of the reference's 6x865-line literal tables
(ant_simulator/bitfusion/src/benchmarks/{ant,ant_weight,bitfusion,olaccel,
adafloat,biscaled}_bench.py): layer *shapes* are generated from the
architectures; per-accelerator *precision* assignments are data (index
lists extracted from the published configurations: ANT's 8-bit lists
mirror the ANT4-8 promotion lists in ant_quantization/ImageNet/scripts,
BitFusion's 4-bit lists mirror the BitFusion paper profiles).

Quirks preserved for cycle parity with the reference simulator:
- Non-square kernels (InceptionV3's 1x7/7x1) enter the cycle model with
  K = the *first* spatial dim only (simulator.py:499 reads
  ``_, K, _, _ = op.weights.shape``), so a 1x7 conv costs K=1 and a 7x1
  conv costs K=7.
- FC layers become 1x1 convs with B = rows (simulator.py:383-403), and
  batch multiplies the row count (benchmarks.py:86-87).
- The GLUE BERT nets (mnli/cola/sst_2) share shapes; the ViT table has
  no patch-embed conv; BERT has pooler + 2-class classifier rows.

The port's copy of the reference's ``perfmodel/nets.py``.
"""

from __future__ import annotations

from typing import List, Union

from .simulator import ConvSpec, MatMulSpec

LayerSpec = Union[ConvSpec, MatMulSpec]

BENCHLIST = ["vgg16", "resnet18", "resnet50", "inceptionv3", "vit",
             "mnli", "cola", "sst_2"]

# ---------------------------------------------------------------------------
# shape generators (precision filled in later; 0 = placeholder)


def _conv(k, o, s, ic, oc, name=""):
    return ConvSpec(k=k, out=o, stride=s, ic=ic, oc=oc, iprec=0, wprec=0,
                    name=name)


def _fc(ni, no, rows=1, name=""):
    return MatMulSpec(ni=ni, no=no, iprec=0, wprec=0, rows=rows, name=name)


def vgg16_layers() -> List[LayerSpec]:
    cfg = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
           (128, 256, 56), (256, 256, 56), (256, 256, 56),
           (256, 512, 28), (512, 512, 28), (512, 512, 28),
           (512, 512, 14), (512, 512, 14), (512, 512, 14)]
    rows = [_conv(3, o, 1, ic, oc, f"conv{i}")
            for i, (ic, oc, o) in enumerate(cfg)]
    rows += [_fc(25088, 4096, name="fc0"), _fc(4096, 4096, name="fc1"),
             _fc(4096, 1000, name="fc2")]
    return rows


def resnet18_layers() -> List[LayerSpec]:
    rows = [_conv(7, 112, 2, 3, 64, "stem")]
    # per stage: (channels, spatial, n_blocks); basic blocks, shortcut conv
    # appended after the first block's two convs on downsampling stages
    in_c = 64
    for ci, (c, o, blocks) in enumerate([(64, 56, 2), (128, 28, 2),
                                         (256, 14, 2), (512, 7, 2)]):
        for b in range(blocks):
            s = 2 if (b == 0 and ci > 0) else 1
            rows.append(_conv(3, o, s, in_c if b == 0 else c, c))
            rows.append(_conv(3, o, 1, c, c))
            if b == 0 and ci > 0:
                rows.append(_conv(1, o, 2, in_c, c, "shortcut"))
        in_c = c
    rows.append(_fc(512, 1000, name="fc"))
    return rows


def resnet50_layers() -> List[LayerSpec]:
    rows = [_conv(7, 112, 2, 3, 64, "stem")]
    in_c = 64
    for ci, (c, o, blocks) in enumerate([(64, 56, 3), (128, 28, 4),
                                         (256, 14, 6), (512, 7, 3)]):
        for b in range(blocks):
            s = 2 if (b == 0 and ci > 0) else 1
            # v1.5 bottleneck: stride lives on the 3x3
            rows.append(_conv(1, o * s if b == 0 and ci > 0 else o, 1,
                              in_c if b == 0 else 4 * c, c))
            rows.append(_conv(3, o, s, c, c))
            rows.append(_conv(1, o, 1, c, 4 * c))
            if b == 0:
                rows.append(_conv(1, o, s, in_c, 4 * c, "shortcut"))
        in_c = 4 * c
    rows.append(_fc(2048, 1000, name="fc"))
    return rows


def inceptionv3_layers() -> List[LayerSpec]:
    r: List[LayerSpec] = []
    # stem
    r += [_conv(3, 149, 2, 3, 32), _conv(3, 147, 1, 32, 32),
          _conv(3, 147, 1, 32, 64), _conv(1, 73, 1, 64, 80),
          _conv(3, 71, 1, 80, 192)]
    # 3x InceptionA at 35x35: 1x1, 5x5 branch, 3x3dbl branch, pool proj
    in_c = 192
    for pool_c in (32, 64, 64):
        r += [_conv(1, 35, 1, in_c, 64),
              _conv(1, 35, 1, in_c, 48), _conv(5, 35, 1, 48, 64),
              _conv(1, 35, 1, in_c, 64), _conv(3, 35, 1, 64, 96),
              _conv(3, 35, 1, 96, 96),
              _conv(1, 35, 1, in_c, pool_c)]
        in_c = 64 + 64 + 96 + pool_c
    # InceptionB reduction -> 17x17
    r += [_conv(3, 17, 2, 288, 384),
          _conv(1, 35, 1, 288, 64), _conv(3, 35, 1, 64, 96),
          _conv(3, 17, 2, 96, 96)]
    # 4x InceptionC at 17x17 (c7 = 128, 160, 160, 192); non-square kernels
    # carry K = first spatial dim (see module docstring)
    for c7 in (128, 160, 160, 192):
        r += [_conv(1, 17, 1, 768, 192),
              _conv(1, 17, 1, 768, c7), _conv(1, 17, 1, c7, c7),   # 1x7
              _conv(7, 17, 1, c7, 192),                            # 7x1
              _conv(1, 17, 1, 768, c7), _conv(7, 17, 1, c7, c7),   # 7x1
              _conv(1, 17, 1, c7, c7),                             # 1x7
              _conv(7, 17, 1, c7, c7),                             # 7x1
              _conv(1, 17, 1, c7, 192),                            # 1x7
              _conv(1, 17, 1, 768, 192)]
    # InceptionD reduction -> 8x8
    r += [_conv(1, 17, 1, 768, 192), _conv(3, 8, 2, 192, 320),
          _conv(1, 17, 1, 768, 192), _conv(1, 17, 1, 192, 192),    # 1x7
          _conv(7, 17, 1, 192, 192),                               # 7x1
          _conv(3, 8, 2, 192, 192)]
    # 2x InceptionE at 8x8
    for in_c in (1280, 2048):
        r += [_conv(1, 8, 1, in_c, 320),
              _conv(1, 8, 1, in_c, 384),
              _conv(1, 8, 1, 384, 384),                            # 1x3
              _conv(3, 8, 1, 384, 384),                            # 3x1
              _conv(1, 8, 1, in_c, 448), _conv(3, 8, 1, 448, 384),
              _conv(1, 8, 1, 384, 384),                            # 1x3
              _conv(3, 8, 1, 384, 384),                            # 3x1
              _conv(1, 8, 1, in_c, 192)]
    r.append(_fc(2048, 1000, name="fc"))
    return r


def vit_layers(patch_embed: bool = False) -> List[LayerSpec]:
    """ViT-B/16, 197 tokens; fused qkv.

    The reference's ANT/OLAccel/AdaFloat/BiScaled tables omit the
    patch-embed conv; only the BitFusion table includes it (a data
    inconsistency preserved here for parity)."""
    r: List[LayerSpec] = []
    if patch_embed:
        r.append(_conv(16, 14, 16, 3, 768, "patch_embed"))
    for i in range(12):
        r += [_fc(768, 2304, 197, f"l{i}.qkv"),
              _fc(768, 768, 197, f"l{i}.out"),
              _fc(768, 3072, 197, f"l{i}.fc1"),
              _fc(3072, 768, 197, f"l{i}.fc2")]
    r.append(_fc(768, 1000, 1, "head"))
    return r


def bert_layers() -> List[LayerSpec]:
    """BERT-base, seq 128: 12 x (q,k,v,out,fc1,fc2) + pooler + classifier."""
    r: List[LayerSpec] = []
    for i in range(12):
        r += [_fc(768, 768, 128, f"l{i}.{n}") for n in ("q", "k", "v", "out")]
        r += [_fc(768, 3072, 128, f"l{i}.fc1"),
              _fc(3072, 768, 128, f"l{i}.fc2")]
    r += [_fc(768, 768, 1, "pooler"), _fc(768, 2, 1, "classifier")]
    return r


_GENERATORS = {
    "vgg16": vgg16_layers,
    "resnet18": resnet18_layers,
    "resnet50": resnet50_layers,
    "inceptionv3": inceptionv3_layers,
    "vit": vit_layers,
    "mnli": bert_layers,
    "cola": bert_layers,
    "sst_2": bert_layers,
}

# ---------------------------------------------------------------------------
# per-accelerator precision assignments (both iprec and wprec get the same
# value, as create_net passes the table precision for data and weights)

# ANT: 4-bit default with the ANT4-8 8-bit promotion lists (first/last
# layers for CNNs per scripts/*_qat.sh, MSE-ranked lists for ViT/BERT)
_ANT_8BIT = {
    "vgg16": [0, 15], "resnet18": [0, 20], "resnet50": [0, 53],
    "inceptionv3": [0, 1, 2, 3, 94],
    "vit": [1, 2, 3, 6, 10, 22, 24, 30, 43, 48],
    "mnli": [48, 49, 50, 59, 72, 73],
    "cola": [37, 42, 43, 44, 48, 49, 50, 59, 72, 73],
    "sst_2": [],
}

# OLAccel: 4-bit with 8-bit first/last conv for CNNs, all-4 transformers
_OLA_8BIT = {
    "vgg16": [0, 15], "resnet18": [0, 20], "resnet50": [0, 53],
    "inceptionv3": [0, 94], "vit": [], "mnli": [], "cola": [], "sst_2": [],
}

# BitFusion: 8-bit default with the paper's per-layer 4-bit profiles
_BIT_4BIT = {
    "vgg16": [10, 12, 14], "resnet18": [16, 19],
    "resnet50": [16, 17, 20, 22, 23, 26, 29, 30, 32, 33, 35, 36, 38, 39,
                 41, 44, 45, 48, 49, 51, 52],
    "inceptionv3": [29, 32, 33, 38, 42, 45, 46, 52, 53, 55, 56, 57, 58, 61,
                    62, 64, 65, 66, 67, 68, 69, 70, 71, 72, 75, 78, 79, 81,
                    82, 83, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94],
    "vit": [2, 22, 30, 34, 38, 42],
    "mnli": [3, 9, 15, 21, 27, 29, 33, 35, 39, 41, 45, 47, 51, 63, 69,
             71, 73],
    "cola": [],
    "sst_2": [3, 5, 9, 11, 15, 21, 23, 27, 29, 33, 35, 39, 41, 45, 47, 51,
              53, 57, 63, 65, 69, 71, 72, 73],
}


def _with_prec(rows: List[LayerSpec], precs: List[int]) -> List[LayerSpec]:
    assert len(rows) == len(precs), (len(rows), len(precs))
    import dataclasses
    return [dataclasses.replace(r, iprec=p, wprec=p)
            for r, p in zip(rows, precs)]


def get_layers(net: str, accel: str) -> List[LayerSpec]:
    """Layer table for ``net`` with ``accel``'s precision assignment.

    accel: 'ant' (also serves ant-ws), 'bitfusion', 'olaccel', 'adafloat',
    'biscaled'.
    """
    if net == "vit" and accel == "bitfusion":
        rows = vit_layers(patch_embed=True)
    else:
        rows = _GENERATORS[net]()
    n = len(rows)
    if accel in ("ant", "ant_weight"):
        eight = set(_ANT_8BIT[net])
        precs = [8 if i in eight else 4 for i in range(n)]
    elif accel == "olaccel":
        eight = set(_OLA_8BIT[net])
        precs = [8 if i in eight else 4 for i in range(n)]
    elif accel == "bitfusion":
        four = set(_BIT_4BIT[net])
        precs = [4 if i in four else 8 for i in range(n)]
    elif accel == "adafloat":
        precs = [8] * n
    elif accel == "biscaled":
        precs = [6] * n
    else:
        raise ValueError(f"unknown accelerator {accel}")
    return _with_prec(rows, precs)
