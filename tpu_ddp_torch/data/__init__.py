"""Host-side data pipeline: CIFAR-10 and ImageNet (or their synthetic
stand-ins), the DistributedSampler-parity shard sampler, crop/flip
augmentation and the batch loader — numpy end to end, handing CPU
tensors to the trainer."""

from tpu_ddp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD


def normalization_constants(dataset: str):
    """(mean, std) on the x/255 scale for a dataset name
    (tpu_ddp/data/__init__.py)."""
    if dataset == "cifar10":
        return CIFAR10_MEAN, CIFAR10_STD
    if dataset == "imagenet":
        from tpu_ddp_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
        return IMAGENET_MEAN, IMAGENET_STD
    raise ValueError(f"unknown dataset {dataset!r}")
