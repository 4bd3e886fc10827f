"""SCConformerXL, its CTC decoder head, and the flax-variables importer."""
