from mjlab_tpu_torch.scene.scene import Scene, SceneCfg, TerrainImporterCfg

__all__ = ["Scene", "SceneCfg", "TerrainImporterCfg"]
