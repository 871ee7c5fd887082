"""Reference attention (ring attention is a later slice)."""
