"""The parallel axes: data parallelism over a process group (:mod:`.mesh`),
ZeRO-3 state sharding over the same ranks (:mod:`.fsdp`), and on 2-D
meshes of the ranks the model axis (:mod:`.tensor_parallel`) and the pipe
axis (:mod:`.pipeline`) of GMD training."""
