from rendering_jax.cli import main

raise SystemExit(main())
