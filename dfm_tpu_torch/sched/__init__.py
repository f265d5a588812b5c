"""Shape bucketing for the fleet's admission control (``buckets``)."""
