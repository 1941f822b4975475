"""The parallel axes: data parallelism over a process group (:mod:`.mesh`),
ZeRO-3 state sharding over the same ranks (:mod:`.fsdp`), and on 2-D
meshes of the ranks the model axis (:mod:`.tensor_parallel`), the pipe
axis (:mod:`.pipeline`) of GMD training and the expert axis of the MoE
head (:mod:`.expert_parallel`); and one process's time-sharded recurrence
over several devices (:mod:`.seq_parallel`), the serving tier's long
videos."""
