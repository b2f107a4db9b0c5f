"""The port's drivers: the demo fixtures (``gen_demo_fixtures``), the
streaming month/year demo (``stream_scale_demo``) and the METAR station
demo (``sparse_scale_demo``). Each runs as ``python -m
weatherbenchx_tpu_torch.tools.<name>``."""
