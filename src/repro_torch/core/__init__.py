"""Workload layer of the port: traces (``trace``), the stitched arena
(``arena``) and the stitched KV cache (``kvcache``)."""
