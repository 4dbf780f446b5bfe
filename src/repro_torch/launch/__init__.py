"""Launch layer of the port: parameter metadata (``sharding``), the
prefill/decode step functions (``steps``) and the model server
(``serve``, ``python -m repro_torch.launch.serve``)."""
