from repro_torch.configs.vgg import VGG5, VGG8, VGGConfig  # noqa: F401
