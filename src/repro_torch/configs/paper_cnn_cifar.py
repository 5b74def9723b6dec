"""The paper's own CNN workload (ResNet-20 on Cifar-10 analogue).

Not one of the 10 assigned transformer architectures — this config drives
the convergence/assumption experiments exactly as the paper did (§6), on
the synthetic Blobs classification task.
"""
from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig(name="paper-cnn-cifar", widths=(16, 32, 64),
                   blocks_per_stage=3, n_classes=10,
                   source="paper §6 (ResNet-20/Cifar-10 analogue)")


def smoke_config() -> CNNConfig:
    return CNNConfig(name="paper-cnn-smoke", widths=(8, 16),
                     blocks_per_stage=1, n_classes=4)
