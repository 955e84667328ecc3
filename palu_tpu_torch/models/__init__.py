"""Port of the palu_tpu.models package."""
