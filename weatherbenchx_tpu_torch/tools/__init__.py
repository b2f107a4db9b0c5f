"""The port's drivers and generators: the demo fixtures
(``gen_demo_fixtures``), the streaming month/year demo
(``stream_scale_demo``), the METAR station demo (``sparse_scale_demo``),
the host-memory breakdown (``rss_breakdown``, run by path), the how-to
notebooks (``make_notebooks``) and the API page (``gen_api_doc``). Each
runs as ``python -m weatherbenchx_tpu_torch.tools.<name>``."""
