"""Per-chunk evaluation, the chunked evaluation pipeline, and the
collectives of many ranks (``distributed``)."""
