"""Launch layer of the port: parameter metadata and the sharded store's
placement (``sharding``), device meshes (``mesh``), the prefill/decode
step functions (``steps``) and the model server (``serve``,
``python -m repro_torch.launch.serve``)."""
