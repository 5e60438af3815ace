"""Model substrate of the port: configs, batch types, parameter schema,
layer math and the paged attention+FFN decoder."""
