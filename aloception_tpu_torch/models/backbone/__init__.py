from .resnet import ResNet, Backbone, Bottleneck, FrozenBatchNorm  # noqa: F401
