"""Host-side policy layers of the port (pure Python, copied from ``repro.core``)."""
