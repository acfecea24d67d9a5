from phyx_tpu_torch.oracle.engine import OracleWorld, collide_box_box_np

__all__ = ["OracleWorld", "collide_box_box_np"]
