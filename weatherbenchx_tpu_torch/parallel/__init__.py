"""Per-chunk evaluation on one device, and the chunked evaluation pipeline."""
