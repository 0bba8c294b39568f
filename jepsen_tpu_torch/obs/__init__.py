"""Observability of the port: so far the device memory poll
(:mod:`jepsen_tpu_torch.obs.devices`) that the segment supervisor reads
for its headroom pre-shrink."""
