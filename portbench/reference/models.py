"""Plain PyTorch reference models: HRNet (Sun et al., CVPR 2019), the
SimpleBaseline ResNet (Xiao et al., ECCV 2018) and the AdvMix UNet mixing
generator (Wang et al., CVPR 2021, after pix2pix's UnetGenerator).

Written from the published architectures in plain `torch.nn` layers and
float32, with no kernel, cast or fusion of the measured program. Module
names follow the published repositories' key paths (`layer1.0.conv1`,
`stage3.2.fuse_layers.0.1.0`, `final_layer`, `model.model.1.model.1`), so
one state dict loads into the program's model and into these alike.

`quant`, where given, is a callable applied to every convolution's input,
weight and output (`numerics.fp8_quant`): the lower-precision control of the
output check, whose activations are all float8 as the program's are all
bfloat16. None computes in float32.

Another architecture joins by a file of its own: `MODEL.NAME` `x` is
`portbench/reference/x.py` with `pose_net(extra, num_joints)` (see
`pose_net` below for what it must hold to).
"""

from __future__ import annotations

import ast
import importlib.util

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1


class Conv(nn.Conv2d):
    """nn.Conv2d whose operands and output pass through `quant` when one is
    set."""

    quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return q(self._conv_forward(q(x), q(self.weight), self.bias))


class Deconv(nn.ConvTranspose2d):
    quant = None

    def forward(self, x):
        q = self.quant or (lambda t: t)
        return q(F.conv_transpose2d(q(x), q(self.weight), self.bias,
                                    self.stride, self.padding,
                                    self.output_padding, self.groups,
                                    self.dilation))


def bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = bn(planes)
        self.downsample = nn.Sequential(
            Conv(cin, planes, 1, stride, bias=False), bn(planes)) \
            if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = bn(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = bn(planes * 4)
        self.downsample = nn.Sequential(
            Conv(cin, planes * 4, 1, stride, bias=False), bn(planes * 4)) \
            if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + r)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck,
          "basic": BasicBlock, "bottleneck": Bottleneck}


def conv_bn(cin, cout, k, stride, relu):
    layers = [Conv(cin, cout, k, stride, k // 2, bias=False), bn(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class Upsample(nn.Module):
    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.factor, mode="nearest")


class HRModule(nn.Module):
    """Parallel branches, then every branch fused into every output."""

    def __init__(self, n, block, num_blocks, cin, channels, multi_out):
        super().__init__()
        cls = BLOCKS[block]
        cout = [c * cls.expansion for c in channels]
        self.branches = nn.ModuleList(
            nn.Sequential(cls(cin[i], channels[i], 1, cin[i] != cout[i]),
                          *[cls(cout[i], channels[i])
                            for _ in range(1, num_blocks[i])])
            for i in range(n))
        self.fuse_layers = None
        if n > 1:
            rows = []
            for i in range(n if multi_out else 1):
                row = []
                for j in range(n):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(nn.Sequential(
                            Conv(cout[j], cout[i], 1, bias=False),
                            bn(cout[i]), Upsample(2 ** (j - i))))
                    else:
                        row.append(nn.Sequential(*[
                            conv_bn(cout[j], cout[i] if k == i - j - 1
                                    else cout[j], 3, 2, k != i - j - 1)
                            for k in range(i - j)]))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        ys = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        out = []
        for row in self.fuse_layers:
            acc = 0
            for j, layer in enumerate(row):
                acc = acc + (ys[j] if layer is None else layer(ys[j]))
            out.append(F.relu(acc))
        return out


class HRNet(nn.Module):
    def __init__(self, extra: dict, num_joints: int):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = bn(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = bn(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, 1, True),
                                    *[Bottleneck(256, 64) for _ in range(3)])
        pre = [256]
        for si in (2, 3, 4):
            s = extra[f"STAGE{si}"]
            cur = [c * BLOCKS[s["BLOCK"]].expansion for c in s["NUM_CHANNELS"]]
            trans = []
            for i in range(len(cur)):
                if i < len(pre):
                    trans.append(conv_bn(pre[i], cur[i], 3, 1, True)
                                 if cur[i] != pre[i] else None)
                else:
                    n_new = i + 1 - len(pre)
                    trans.append(nn.Sequential(*[
                        conv_bn(pre[-1], cur[i] if k == n_new - 1
                                else pre[-1], 3, 2, True)
                        for k in range(n_new)]))
            setattr(self, f"transition{si - 1}", nn.ModuleList(trans))
            m = s["NUM_MODULES"]
            setattr(self, f"stage{si}", nn.Sequential(*[
                HRModule(s["NUM_BRANCHES"], s["BLOCK"], s["NUM_BLOCKS"], cur,
                         s["NUM_CHANNELS"], not (si == 4 and k == m - 1))
                for k in range(m)]))
            pre = cur
        k = extra["FINAL_CONV_KERNEL"]
        self.final_layer = Conv(pre[0], num_joints, k, 1, 1 if k == 3 else 0,
                                bias=True)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si in (2, 3, 4):
            trans = getattr(self, f"transition{si - 1}")
            xs = [xs[i] if t is None else t(xs[i] if i < len(xs) else xs[-1])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{si}")(xs)
        return self.final_layer(xs[0])


RESNET_SPEC = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
               50: ("bottleneck", (3, 4, 6, 3)),
               101: ("bottleneck", (3, 4, 23, 3)),
               152: ("bottleneck", (3, 8, 36, 3))}


class PoseResNet(nn.Module):
    def __init__(self, extra: dict, num_joints: int):
        super().__init__()
        kind, layers = RESNET_SPEC[extra["NUM_LAYERS"]]
        block = BLOCKS[kind]
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for li, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1):
            ds = stride != 1 or cin != planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(
                block(cin, planes, stride, ds),
                *[block(planes * block.expansion, planes)
                  for _ in range(1, n)]))
            cin = planes * block.expansion
        deconv = []
        for i in range(extra["NUM_DECONV_LAYERS"]):
            k = extra["NUM_DECONV_KERNELS"][i]
            pad, out_pad = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]
            cout = extra["NUM_DECONV_FILTERS"][i]
            deconv += [Deconv(cin, cout, k, 2, pad, out_pad,
                              bias=extra["DECONV_WITH_BIAS"]),
                       bn(cout), nn.ReLU()]
            cin = cout
        self.deconv_layers = nn.Sequential(*deconv)
        k = extra["FINAL_CONV_KERNEL"]
        self.final_layer = Conv(cin, num_joints, k, 1, 1 if k == 3 else 0,
                                bias=True)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.final_layer(self.deconv_layers(x))


class UnetBlock(nn.Module):
    """One UNet level: LeakyReLU, down conv k4 s2, inner level, ReLU, up
    transposed conv k4 s2, InstanceNorm (no affine), and the skip concat;
    no norm on the outermost and the innermost down conv, none after the
    outermost up conv."""

    def __init__(self, outer, inner, cin, sub, outermost=False):
        super().__init__()
        self.outermost = outermost
        cin = outer if cin is None else cin
        down = Conv(cin, inner, 4, 2, 1, bias=True)

        def inorm(c):
            return nn.InstanceNorm2d(c, eps=1e-5, affine=False)

        if outermost:
            layers = [down, sub, nn.ReLU(),
                      Deconv(inner * 2, outer, 4, 2, 1, bias=True)]
        elif sub is None:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                      Deconv(inner, outer, 4, 2, 1, bias=True), inorm(outer)]
        else:
            layers = [nn.LeakyReLU(0.2), down, inorm(inner), sub, nn.ReLU(),
                      Deconv(inner * 2, outer, 4, 2, 1, bias=True),
                      inorm(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class Unet(nn.Module):
    def __init__(self, cin=9, cout=3, num_downs=6, ngf=64):
        super().__init__()
        f = [ngf * min(2 ** i, 8) for i in range(num_downs)]
        block = UnetBlock(f[-2], f[-1], None, None)
        for i in range(num_downs - 2, 0, -1):
            block = UnetBlock(f[i - 1], f[i], None, block)
        self.model = UnetBlock(cout, f[0], cin, block, outermost=True)

    def forward(self, x):
        return self.model(x)


# the only top-level modules a file of `portbench/reference/` may import:
# plain libraries, nothing of the program and nothing of JAX
PLAIN_IMPORTS = frozenset({"__future__", "ast", "collections", "contextlib",
                           "copy", "glob", "importlib", "math", "os",
                           "numpy", "scipy", "torch", "cv2"})
BUILT_IN = {"pose_hrnet": HRNet, "pose_resnet": PoseResNet}


def imports_of(path: str) -> set:
    """The top-level names of the absolute imports in the file `path`, and
    of `import_module` calls on a name that starts with a constant
    (relative imports stay inside the file's package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
    return names


def architecture(name: str):
    """The module `portbench/reference/<name>.py` of an architecture that is
    not built in, held to its contract: it exists, imports only
    `PLAIN_IMPORTS`, and has `pose_net(extra, num_joints)`."""
    if not name.isidentifier():
        raise KeyError(f"MODEL.NAME {name!r} is no module name")
    full = f"{__package__}.{name}"
    spec = importlib.util.find_spec(full)
    if spec is None or spec.origin is None:
        raise KeyError(f"no reference for MODEL.NAME {name!r}: add "
                       f"portbench/reference/{name}.py with "
                       "pose_net(extra, num_joints)")
    # read before the module runs, so that nothing else is ever loaded
    bad = imports_of(spec.origin) - PLAIN_IMPORTS
    if bad:
        raise ImportError(f"{spec.origin} imports {sorted(bad)}: a reference "
                          f"may import only {sorted(PLAIN_IMPORTS)}")
    mod = importlib.import_module(full)
    if not callable(getattr(mod, "pose_net", None)):
        raise TypeError(f"{spec.origin} has no pose_net(extra, num_joints)")
    return mod


def pose_net(model_cfg: dict) -> nn.Module:
    """The pose network that a configuration file's "model" block names:
    a built-in, or `architecture(NAME).pose_net(EXTRA, NUM_JOINTS)`, whose
    head must be the convolution `final_layer` (the output layer that
    `inputs.he_init_` starts small). Its state dict's names must be the
    program's `get_pose_net(cfg)`'s (`kinds.common.port_pose` checks)."""
    extra = model_cfg["EXTRA"]
    joints = model_cfg["NUM_JOINTS"]
    name = model_cfg["NAME"]
    if name in BUILT_IN:
        return BUILT_IN[name](extra, joints)
    net = architecture(name).pose_net(extra, joints)
    if not isinstance(getattr(net, "final_layer", None), nn.Conv2d):
        raise TypeError(f"portbench/reference/{name}.py: the head must be a "
                        "convolution named final_layer")
    return net


def set_quant(model: nn.Module, quant) -> nn.Module:
    """Route every module of `model` that has a `quant` attribute (the
    convolutions here; a file of another architecture may add its own)
    through `quant` (None: f32)."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant
    return model
