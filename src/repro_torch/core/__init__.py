"""Workload layer of the port: traces (``trace``), the stitched arena
(``arena``), the stitched KV cache (``kvcache``) and host offload
(``offload``)."""
