"""The SPMD tier of the port: the sharding plan (``plan``) and the GPipe
pipeline over a process group (``pipeline``)."""
