"""Per-chunk evaluation on one device."""
