from .dist import get_num_processes, get_rank, get_world_size, host_allgather, host_allgather_objects, is_distributed

__all__ = ["get_world_size", "get_rank", "get_num_processes", "is_distributed",
           "host_allgather", "host_allgather_objects"]
