"""Sharding over a device mesh: the reference's PartitionSpecs
(`sharding.py`) and logical activation axes (`axes.py`), realised as
`torch.distributed` DTensor placements."""
