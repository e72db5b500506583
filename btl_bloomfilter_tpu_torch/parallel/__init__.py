"""The distribution layer on ``torch.distributed``: replicated and sharded
Bloom, counting and multi-index Bloom filters, one rank a process."""
