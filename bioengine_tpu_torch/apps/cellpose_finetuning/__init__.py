"""cellpose fine-tuning: training sessions, live 2D/3D inference, export."""
