"""Host-side data pipeline: CIFAR-10 (or its synthetic stand-in), the
DistributedSampler-parity shard sampler, crop/flip augmentation and the
batch loader — numpy end to end, handing CPU tensors to the trainer."""
