class RuntimeA:
    async def transform(self, value):
        return value * 2
