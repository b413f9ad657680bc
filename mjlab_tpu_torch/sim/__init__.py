from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg

__all__ = ["MujocoCfg", "Simulation", "SimulationCfg"]
