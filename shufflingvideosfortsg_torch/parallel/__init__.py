"""The data axis: data parallelism over a process group
(:mod:`.mesh`) and ZeRO-3 state sharding over the same ranks
(:mod:`.fsdp`)."""
