"""Port of the palu_tpu.runtime package."""
