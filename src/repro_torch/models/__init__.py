"""The model tier of the port, dense family (llama3.2-1b): parameters,
layers, GQA attention on the flash- and paged-attention kernels, the
transformer stack and the ``Model`` facade."""
