"""At-rest compression format (numpy), byte-identical to ``repro.core``."""
