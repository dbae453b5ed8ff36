"""Vision model zoo: AlexNet, ResNet-50, ResNeXt-50, Inception-v3 (port
of ``flexflow_tpu/models/vision.py``, with its layer names).

Reference: examples/cpp/AlexNet/alexnet.cc, examples/cpp/ResNet/resnet.cc,
examples/cpp/resnext50/resnext.cc, examples/cpp/InceptionV3/inception.cc
(+ bootcamp_demo/ff_alexnet_cifar10.py). Layer configurations mirror the
reference examples; inputs are logical NCHW for API parity.
"""
from __future__ import annotations

from ..config import FFConfig
from ..core.types import ActiMode, PoolType
from ..model import FFModel, Tensor


def build_alexnet(config: FFConfig, num_classes: int = 10, image_hw: int = 224,
                  device=None) -> FFModel:
    """Reference: examples/cpp/AlexNet/alexnet.cc top_level_task."""
    model = FFModel(config, device=device)
    x = model.create_tensor((config.batch_size, 3, image_hw, image_hw), name="image")
    t = model.conv2d(x, 64, 11, 11, 4, 4, 2, 2, ActiMode.RELU, name="conv1")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.RELU, name="conv2")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv3")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv4")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv5")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool5")
    t = model.flat(t, name="flat")
    t = model.dense(t, 4096, ActiMode.RELU, name="fc6")
    t = model.dense(t, 4096, ActiMode.RELU, name="fc7")
    t = model.dense(t, num_classes, name="fc8")
    model.softmax(t, name="softmax")
    return model


def _bottleneck(model: FFModel, t: Tensor, out_channels: int, stride: int, idx: str, groups: int = 1, width_mult: int = 1) -> Tensor:
    """ResNet-50 bottleneck (reference: resnet.cc BottleneckBlock):
    1x1 -> 3x3 -> 1x1 with batch-norm, projection shortcut on stride/width change."""
    shortcut = t
    width = out_channels // 4 * width_mult
    h = model.conv2d(t, width, 1, 1, 1, 1, 0, 0, name=f"{idx}_c1")
    h = model.batch_norm(h, relu=True, name=f"{idx}_bn1")
    h = model.conv2d(h, width, 3, 3, stride, stride, 1, 1, groups=groups, name=f"{idx}_c2")
    h = model.batch_norm(h, relu=True, name=f"{idx}_bn2")
    h = model.conv2d(h, out_channels, 1, 1, 1, 1, 0, 0, name=f"{idx}_c3")
    h = model.batch_norm(h, relu=False, name=f"{idx}_bn3")
    if stride != 1 or t.shape[1] != out_channels:
        shortcut = model.conv2d(t, out_channels, 1, 1, stride, stride, 0, 0, name=f"{idx}_proj")
        shortcut = model.batch_norm(shortcut, relu=False, name=f"{idx}_projbn")
    h = model.add(h, shortcut, name=f"{idx}_add")
    return model.relu(h, name=f"{idx}_relu")


def build_resnet50(config: FFConfig, num_classes: int = 1000, image_hw: int = 224,
                   groups: int = 1, width_mult: int = 1, device=None) -> FFModel:
    """Reference: examples/cpp/ResNet/resnet.cc (and resnext50 with
    groups=32, width_mult=2)."""
    model = FFModel(config, device=device)
    x = model.create_tensor((config.batch_size, 3, image_hw, image_hw), name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="conv1")
    t = model.batch_norm(t, relu=True, name="bn1")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    for stage, (blocks, channels) in enumerate([(3, 256), (4, 512), (6, 1024), (3, 2048)]):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            t = _bottleneck(model, t, channels, stride, f"s{stage}b{b}", groups, width_mult)
    # global average pool
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.AVG, name="gap")
    t = model.flat(t, name="flat")
    t = model.dense(t, num_classes, name="fc")
    model.softmax(t, name="softmax")
    return model


def build_resnext50(config: FFConfig, num_classes: int = 1000, image_hw: int = 224,
                    device=None) -> FFModel:
    """Reference: examples/cpp/resnext50 — ResNeXt-50 32x4d."""
    return build_resnet50(config, num_classes, image_hw, groups=32, width_mult=2, device=device)


def _inception_a(model, t, pool_features, idx):
    b1 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b1")
    b2 = model.conv2d(t, 48, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b2a")
    b2 = model.conv2d(b2, 64, 5, 5, 1, 1, 2, 2, ActiMode.RELU, name=f"{idx}_b2b")
    b3 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b3a")
    b3 = model.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name=f"{idx}_b3b")
    b3 = model.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name=f"{idx}_b3c")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{idx}_b4p")
    b4 = model.conv2d(b4, pool_features, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b4")
    return model.concat([b1, b2, b3, b4], axis=1, name=f"{idx}_cat")


def _inception_b(model, t, idx):
    b1 = model.conv2d(t, 384, 3, 3, 2, 2, 0, 0, ActiMode.RELU, name=f"{idx}_b1")
    b2 = model.conv2d(t, 64, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b2a")
    b2 = model.conv2d(b2, 96, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name=f"{idx}_b2b")
    b2 = model.conv2d(b2, 96, 3, 3, 2, 2, 0, 0, ActiMode.RELU, name=f"{idx}_b2c")
    b3 = model.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"{idx}_b3")
    return model.concat([b1, b2, b3], axis=1, name=f"{idx}_cat")


def _inception_c(model, t, c7, idx):
    b1 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b1")
    b2 = model.conv2d(t, c7, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b2a")
    b2 = model.conv2d(b2, c7, 1, 7, 1, 1, 0, 3, ActiMode.RELU, name=f"{idx}_b2b")
    b2 = model.conv2d(b2, 192, 7, 1, 1, 1, 3, 0, ActiMode.RELU, name=f"{idx}_b2c")
    b3 = model.conv2d(t, c7, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b3a")
    b3 = model.conv2d(b3, c7, 7, 1, 1, 1, 3, 0, ActiMode.RELU, name=f"{idx}_b3b")
    b3 = model.conv2d(b3, c7, 1, 7, 1, 1, 0, 3, ActiMode.RELU, name=f"{idx}_b3c")
    b3 = model.conv2d(b3, c7, 7, 1, 1, 1, 3, 0, ActiMode.RELU, name=f"{idx}_b3d")
    b3 = model.conv2d(b3, 192, 1, 7, 1, 1, 0, 3, ActiMode.RELU, name=f"{idx}_b3e")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{idx}_b4p")
    b4 = model.conv2d(b4, 192, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b4")
    return model.concat([b1, b2, b3, b4], axis=1, name=f"{idx}_cat")


def _inception_d(model, t, idx):
    b1 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b1a")
    b1 = model.conv2d(b1, 320, 3, 3, 2, 2, 0, 0, ActiMode.RELU, name=f"{idx}_b1b")
    b2 = model.conv2d(t, 192, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b2a")
    b2 = model.conv2d(b2, 192, 1, 7, 1, 1, 0, 3, ActiMode.RELU, name=f"{idx}_b2b")
    b2 = model.conv2d(b2, 192, 7, 1, 1, 1, 3, 0, ActiMode.RELU, name=f"{idx}_b2c")
    b2 = model.conv2d(b2, 192, 3, 3, 2, 2, 0, 0, ActiMode.RELU, name=f"{idx}_b2d")
    b3 = model.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"{idx}_b3")
    return model.concat([b1, b2, b3], axis=1, name=f"{idx}_cat")


def _inception_e(model, t, idx):
    b1 = model.conv2d(t, 320, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b1")
    b2 = model.conv2d(t, 384, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b2")
    b2a = model.conv2d(b2, 384, 1, 3, 1, 1, 0, 1, ActiMode.RELU, name=f"{idx}_b2a")
    b2b = model.conv2d(b2, 384, 3, 1, 1, 1, 1, 0, ActiMode.RELU, name=f"{idx}_b2b")
    b2 = model.concat([b2a, b2b], axis=1, name=f"{idx}_b2cat")
    b3 = model.conv2d(t, 448, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b3")
    b3 = model.conv2d(b3, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name=f"{idx}_b3b")
    b3a = model.conv2d(b3, 384, 1, 3, 1, 1, 0, 1, ActiMode.RELU, name=f"{idx}_b3c")
    b3b = model.conv2d(b3, 384, 3, 1, 1, 1, 1, 0, ActiMode.RELU, name=f"{idx}_b3d")
    b3 = model.concat([b3a, b3b], axis=1, name=f"{idx}_b3cat")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{idx}_b4p")
    b4 = model.conv2d(b4, 192, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name=f"{idx}_b4")
    return model.concat([b1, b2, b3, b4], axis=1, name=f"{idx}_cat")


def build_inception_v3(config: FFConfig, num_classes: int = 1000, image_hw: int = 299,
                       device=None) -> FFModel:
    """Reference: examples/cpp/InceptionV3/inception.cc."""
    model = FFModel(config, device=device)
    x = model.create_tensor((config.batch_size, 3, image_hw, image_hw), name="image")
    t = model.conv2d(x, 32, 3, 3, 2, 2, 0, 0, ActiMode.RELU, name="c1")
    t = model.conv2d(t, 32, 3, 3, 1, 1, 0, 0, ActiMode.RELU, name="c2")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="c3")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="p1")
    t = model.conv2d(t, 80, 1, 1, 1, 1, 0, 0, ActiMode.RELU, name="c4")
    t = model.conv2d(t, 192, 3, 3, 1, 1, 0, 0, ActiMode.RELU, name="c5")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="p2")
    t = _inception_a(model, t, 32, "a1")
    t = _inception_a(model, t, 64, "a2")
    t = _inception_a(model, t, 64, "a3")
    t = _inception_b(model, t, "b1")
    t = _inception_c(model, t, 128, "c6")
    t = _inception_c(model, t, 160, "c7")
    t = _inception_c(model, t, 160, "c8")
    t = _inception_c(model, t, 192, "c9")
    t = _inception_d(model, t, "d1")
    t = _inception_e(model, t, "e1")
    t = _inception_e(model, t, "e2")
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.AVG, name="gap")
    t = model.flat(t, name="flat")
    t = model.dense(t, num_classes, name="fc")
    model.softmax(t, name="softmax")
    return model
