"""The model tier of the port: parameters, layers, GQA attention on the
flash- and paged-attention kernels, the Mamba2 block on the SSD-scan kernel,
the MoE layer, the transformer stacks of the dense (llama3.2-1b), moe
(mixtral-8x7b, with the sliding-window ring), ssm (mamba2-780m) and hybrid
(zamba2-1.2b) families and the ``Model`` facade."""
