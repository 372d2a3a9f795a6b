"""CNN workloads evaluated in the paper: ResNet-50 [4], MobileNet-v3 [6],
U-Net [5]; VGG-16 is included because the paper uses it to size the fusion
state space (2^16, §III-A).  Batch = 1 (edge inference, §V).

All builders emit a :class:`repro_torch.core.graph.LayerGraph` whose node insertion
order is topological.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from repro_torch.core.graph import Layer, LayerGraph


class _Builder:
    """Tracks the running activation shape while appending layers."""

    def __init__(self, name: str, c: int, h: int, w: int):
        self.g = LayerGraph(name)
        self.head = self.g.add(Layer(name="input", kind="input",
                                     m=c, p=h, q=w))
        self.c, self.h, self.w = c, h, w
        self._uid = 0

    def _name(self, base: str) -> str:
        self._uid += 1
        return f"{base}_{self._uid}"

    @staticmethod
    def _out_hw(h, w, r, s, stride, pad, dil=(1, 1)):
        p = (h + 2 * pad[0] - dil[0] * (r - 1) - 1) // stride[0] + 1
        q = (w + 2 * pad[1] - dil[1] * (s - 1) - 1) // stride[1] + 1
        return p, q

    def conv(self, m: int, k: int = 3, stride: int = 1,
             pad: Optional[int] = None, groups: int = 1,
             kind: str = "conv", base: str = "conv",
             src: Optional[str] = None) -> str:
        src = src or self.head
        pad = (k // 2) if pad is None else pad
        p, q = self._out_hw(self.h, self.w, k, k, (stride, stride), (pad, pad))
        lname = self.g.add(Layer(
            name=self._name(base), kind=kind, c=self.c, h=self.h, w=self.w,
            m=m, p=p, q=q, r=k, s=k, stride=(stride, stride),
            padding=(pad, pad), groups=groups), [src])
        self.head, self.c, self.h, self.w = lname, m, p, q
        return lname

    def dwconv(self, k: int, stride: int = 1) -> str:
        return self.conv(self.c, k=k, stride=stride, groups=self.c,
                         kind="dwconv", base="dw")

    def pool(self, k: int = 2, stride: Optional[int] = None, pad: int = 0) -> str:
        stride = stride or k
        p, q = self._out_hw(self.h, self.w, k, k, (stride, stride), (pad, pad))
        lname = self.g.add(Layer(
            name=self._name("pool"), kind="pool", c=self.c, h=self.h,
            w=self.w, m=self.c, p=p, q=q, r=k, s=k,
            stride=(stride, stride), padding=(pad, pad)), [self.head])
        self.head, self.h, self.w = lname, p, q
        return lname

    def global_pool(self) -> str:
        lname = self.g.add(Layer(
            name=self._name("gpool"), kind="global_pool", c=self.c, h=self.h,
            w=self.w, m=self.c, p=1, q=1, r=self.h, s=self.w), [self.head])
        self.head, self.h, self.w = lname, 1, 1
        return lname

    def fc(self, m: int, src: Optional[str] = None) -> str:
        src = src or self.head
        lname = self.g.add(Layer(
            name=self._name("fc"), kind="fc",
            c=self.c * self.h * self.w, h=1, w=1, m=m, p=1, q=1), [src])
        self.head, self.c, self.h, self.w = lname, m, 1, 1
        return lname

    def add_residual(self, a: str, b: str) -> str:
        lname = self.g.add(Layer(
            name=self._name("add"), kind="add", c=self.c, h=self.h, w=self.w,
            m=self.c, p=self.h, q=self.w), [a, b])
        self.head = lname
        return lname

    def mul(self, a: str, b: str) -> str:
        lname = self.g.add(Layer(
            name=self._name("mul"), kind="mul", c=self.c, h=self.h, w=self.w,
            m=self.c, p=self.h, q=self.w), [a, b])
        self.head = lname
        return lname

    def concat(self, a: str, b: str, channels: int) -> str:
        lname = self.g.add(Layer(
            name=self._name("cat"), kind="concat", c=channels, h=self.h,
            w=self.w, m=channels, p=self.h, q=self.w), [a, b])
        self.head, self.c = lname, channels
        return lname

    def upsample(self, scale: int = 2) -> str:
        p, q = self.h * scale, self.w * scale
        lname = self.g.add(Layer(
            name=self._name("up"), kind="upsample", c=self.c, h=self.h,
            w=self.w, m=self.c, p=p, q=q), [self.head])
        self.head, self.h, self.w = lname, p, q
        return lname

    def done(self) -> LayerGraph:
        self.g.validate()
        return self.g


# ---- ResNet-50 [He et al. 2015] ---------------------------------------------------

def resnet50(hw: int = 224) -> LayerGraph:
    b = _Builder("resnet50", 3, hw, hw)
    b.conv(64, k=7, stride=2)
    b.pool(k=3, stride=2, pad=1)
    cfg = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2),
           (512, 2048, 3, 2)]
    for width, out_ch, blocks, first_stride in cfg:
        for i in range(blocks):
            stride = first_stride if i == 0 else 1
            skip_src = b.head
            skip_c, skip_h, skip_w = b.c, b.h, b.w
            b.conv(width, k=1, stride=1, base="red")
            b.conv(width, k=3, stride=stride)
            b.conv(out_ch, k=1, stride=1, base="exp")
            if i == 0:
                # projection shortcut
                main = b.head
                b.head, b.c, b.h, b.w = skip_src, skip_c, skip_h, skip_w
                short = b.conv(out_ch, k=1, stride=stride, base="short")
                b.head = main
                skip_src = short
            b.add_residual(b.head, skip_src)
    b.global_pool()
    b.fc(1000)
    return b.done()


# ---- MobileNet-v3-Large [Howard et al. 2019] ----------------------------------------

def _bneck(b: _Builder, k: int, exp: int, out: int, se: bool, stride: int):
    src = b.head
    src_c, src_h, src_w = b.c, b.h, b.w
    if exp != b.c:
        b.conv(exp, k=1, base="expand")
    b.dwconv(k, stride=stride)
    if se:
        dw_out = b.head
        dw_c, dw_h, dw_w = b.c, b.h, b.w
        b.global_pool()
        b.fc(max(exp // 4, 8))
        b.fc(exp)
        se_out = b.head
        b.head, b.c, b.h, b.w = dw_out, dw_c, dw_h, dw_w
        b.mul(dw_out, se_out)
    b.conv(out, k=1, base="project")
    if stride == 1 and src_c == out:
        b.add_residual(b.head, src)


def mobilenet_v3_large(hw: int = 224) -> LayerGraph:
    b = _Builder("mobilenet_v3", 3, hw, hw)
    b.conv(16, k=3, stride=2)
    specs = [
        (3, 16, 16, False, 1), (3, 64, 24, False, 2), (3, 72, 24, False, 1),
        (5, 72, 40, True, 2), (5, 120, 40, True, 1), (5, 120, 40, True, 1),
        (3, 240, 80, False, 2), (3, 200, 80, False, 1),
        (3, 184, 80, False, 1), (3, 184, 80, False, 1),
        (3, 480, 112, True, 1), (3, 672, 112, True, 1),
        (5, 672, 160, True, 2), (5, 960, 160, True, 1),
        (5, 960, 160, True, 1),
    ]
    for k, exp, out, se, stride in specs:
        _bneck(b, k, exp, out, se, stride)
    b.conv(960, k=1)
    b.global_pool()
    b.fc(1280)
    b.fc(1000)
    return b.done()


# ---- U-Net [Ronneberger et al. 2015], 'same'-padded variant -------------------------

def unet(hw: int = 256, base_ch: int = 64, depth: int = 4,
         in_ch: int = 1, out_ch: int = 2) -> LayerGraph:
    b = _Builder("unet", in_ch, hw, hw)
    skips: List[Tuple[str, int, int, int]] = []
    ch = base_ch
    for _ in range(depth):
        b.conv(ch, k=3)
        b.conv(ch, k=3)
        skips.append((b.head, b.c, b.h, b.w))
        b.pool(k=2)
        ch *= 2
    b.conv(ch, k=3)
    b.conv(ch, k=3)
    for (skip, sc, sh, sw) in reversed(skips):
        b.upsample(2)
        b.conv(b.c // 2, k=3, base="upconv")
        b.concat(b.head, skip, b.c + sc)
        b.conv(b.c // 2, k=3)
        b.conv(b.c, k=3)
    b.conv(out_ch, k=1, base="head")
    return b.done()


# ---- VGG-16 ---------------------------------------------------------------------------

def vgg16(hw: int = 224) -> LayerGraph:
    b = _Builder("vgg16", 3, hw, hw)
    for reps, ch in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        for _ in range(reps):
            b.conv(ch, k=3)
        b.pool(k=2)
    b.fc(4096)
    b.fc(4096)
    b.fc(1000)
    return b.done()


WORKLOADS = {
    "resnet50": resnet50,
    "mobilenet_v3": mobilenet_v3_large,
    "unet": unet,
    "vgg16": vgg16,
}


def build_workload(name: str, **kw) -> LayerGraph:
    return WORKLOADS[name](**kw)
